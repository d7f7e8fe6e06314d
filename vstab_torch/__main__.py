"""`python -m vstab_torch ...` entry point."""

import sys

from vstab_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
