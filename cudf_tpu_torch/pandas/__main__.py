"""python -m cudf_tpu_torch.pandas [--device DEV] script.py [args...]

Runs ``script.py`` as ``__main__`` with ``import pandas`` giving the
accelerator's proxy module over DEV (default ``cuda``, where there is
no slow side; pandas is the slow side only with ``--device cpu``).
(reference: ``cudf_tpu/pandas/__main__.py``)
"""

import runpy
import sys

import cudf_tpu_torch.pandas

USAGE = "usage: python -m cudf_tpu_torch.pandas [--device DEV] <script.py> [args...]"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    while argv[:1] and argv[0].startswith("--"):      # options before the script
        if argv[0] == "--device" and len(argv) > 1:
            device, argv = argv[1], argv[2:]
        elif argv[0].startswith("--device="):
            device, argv = argv[0].split("=", 1)[1], argv[1:]
        else:
            break
    if not argv or argv[0].startswith("--"):
        print(USAGE, file=sys.stderr)
        sys.exit(1)
    cudf_tpu_torch.pandas.install(device=device)
    sys.argv = argv
    runpy.run_path(argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
