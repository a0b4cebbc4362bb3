"""`python -m femx_torch`: the command-line interface (femx_torch.cli)."""

import sys

from femx_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
