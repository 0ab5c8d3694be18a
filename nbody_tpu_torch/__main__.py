"""`python -m nbody_tpu_torch` == the benchmark CLI (cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
