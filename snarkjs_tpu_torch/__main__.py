"""`python -m snarkjs_tpu_torch <command> ...`: the CLI (cli.py).  Importing
this module runs nothing."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
