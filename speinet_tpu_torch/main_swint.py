"""SWINT training entry (port of `speinet_tpu/main_swint.py`; parity:
main_swint.py): `main_train` with the SWINT template.

    python -m speinet_tpu_torch.main_swint --dir_data <train-tree> \\
        --dir_data_test <val-tree> --experiment_dir ./experiment --save swint

`--template SWINT` is prepended unless a template is given; every other
flag, `--device` among them (the card unless `--device cpu`), is
`main_train`'s.
"""

from __future__ import annotations

import sys

from speinet_tpu_torch.main_train import main as _main


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.split("=")[0] == "--template" for a in argv):
        argv = ["--template", "SWINT"] + argv
    _main(argv)


if __name__ == "__main__":
    main()
