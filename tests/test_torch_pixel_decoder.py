"""The pixel-decoder entry point (``models.pixel_decoder.evaluate``)
against the JAX package's, at ``llmseg_tiny`` + ``sam_tiny``, one image, 4
new tokens.  JAX initialises both trees; every leaf is jittered with seeded
numpy noise and loaded strictly into the port's modules by
``import_weights.from_jax``.  With random weights a generated [SEG] is
rare, and without one ``evaluate`` returns -1e9 everywhere, so the test
declares the first token the model emits to be [SEG] (``seg_token_id``)
on both sides: the mask path then runs.  float32 on the CPU, JAX at
highest matmul precision.  Tokens must be equal, the mask logits within
1e-4 (generation, the text projection, the SAM encoder and decoder and two
resizes in float32, summed in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.models import pixel_decoder as jpd
from llmseg_tpu.models.sam import sam as jsam
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.models import pixel_decoder as tpd
from llmseg_tpu_torch.models.sam import sam as tsam

torch.set_num_threads(1)
MASK_TOL = 1e-4


def _jitter(params, seed, amp):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + amp * rng.randn(*np.shape(x))).astype(np.float32), params)


def test_evaluate_matches_jax():
    p = _jitter(jllmseg.init(jax.random.PRNGKey(0), JC.llmseg_tiny()), 1, 0.05)
    sp = _jitter(jsam.init(jax.random.PRNGKey(1), JC.sam_tiny()), 2, 0.1)
    rng = np.random.RandomState(3)
    B, img, simg = 1, JC.llmseg_tiny().llava.vision.img_size, JC.sam_tiny().encoder.img_size
    images_clip = rng.randn(B, img, img, 3).astype(np.float32)
    images_sam = rng.randn(B, simg, simg, 3).astype(np.float32)
    ids = rng.randint(4, 200, (B, 12))
    image_pos = np.ones((B,), np.int32)
    hw = dict(input_hw=(48, 64), original_hw=(96, 128))

    sam_t = load_(tsam.build(TC.sam_tiny(), device="cpu"), sp)
    inputs = dict(images_clip=torch.tensor(images_clip), input_ids=torch.tensor(ids),
                  image_pos=torch.tensor(image_pos))
    first = int(tpd.generate_answer(
        load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"), p), max_new_tokens=1,
        **inputs)[0][0, 0])
    model_t = load_(tllmseg.build(TC.replace(TC.llmseg_tiny(), seg_token_id=first),
                                  device="cpu"), p)

    tj, mj = jpd.evaluate(jax.tree.map(jnp.asarray, p),
                          JC.replace(JC.llmseg_tiny(), seg_token_id=first),
                          jax.tree.map(jnp.asarray, sp), JC.sam_tiny(),
                          images_clip=jnp.asarray(images_clip),
                          images_sam=jnp.asarray(images_sam), input_ids=jnp.asarray(ids),
                          image_pos=jnp.asarray(image_pos), max_new_tokens=4, **hw)
    tt, mt = tpd.evaluate(model_t, sam_t, images_sam=torch.tensor(images_sam), max_new_tokens=4,
                          device="cpu", **inputs, **hw)
    assert tt.shape == (B, 4) and mt.shape == (B, 96, 128)
    assert int(tt[0, 0]) == first and bool((mt > -1e8).all())
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    np.testing.assert_allclose(np.asarray(mj), mt.numpy(), atol=MASK_TOL, rtol=0)

    # a row without [SEG] gets -1e9, as JAX's select gives
    model_t.cfg = TC.replace(model_t.cfg, seg_token_id=-1)
    _, none = tpd.evaluate(model_t, sam_t, images_sam=torch.tensor(images_sam),
                           max_new_tokens=4, device="cpu", **inputs, **hw)
    assert bool((none == -1e9).all())
