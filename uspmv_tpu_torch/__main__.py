"""`python -m uspmv_tpu_torch` = the uspmv_tpu_torch CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
