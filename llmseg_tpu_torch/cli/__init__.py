"""The port's command line, the counterpart of the JAX package's ``cli/``:
``python -m llmseg_tpu_torch.cli.<name>`` for ``train``, ``finetune``,
``validate``, ``prepare`` and ``convert_h5``.  Each runs on the card unless
``--device cpu`` is given (``convert_h5`` runs on the host alone)."""
