"""Reference-format h5 mask files to masks.json, the counterpart of the JAX
package's ``cli/convert_h5.py`` (the reference's
prepare_datasets/convert_h5_to_json.py, with ``ast.literal_eval`` in place
of its ``eval`` of the stored strings).  Host only.

Usage: python -m llmseg_tpu_torch.cli.convert_h5 --input masks.h5 --output masks.json
"""

from __future__ import annotations

import argparse
import ast
import json


def convert(input_path: str, output_path: str) -> int:
    import h5py

    results = []
    with h5py.File(input_path, "r") as h5:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                raw = obj[()]
                if isinstance(raw, bytes):
                    raw = raw.decode("utf-8")
                record = ast.literal_eval(str(raw))
                if isinstance(record, dict) and "masks" in record:
                    results.append(record)
                else:   # the reference's layout: the value is the masks list
                    results.append({"image": name, "masks": record})

        h5.visititems(visit)
    with open(output_path, "w") as f:
        json.dump(results, f)
    return len(results)


def main(argv=None):
    p = argparse.ArgumentParser("convert_h5")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    n = convert(args.input, args.output)
    print(f"wrote {args.output} ({n} images)")


if __name__ == "__main__":
    main()
