"""``python -m scalable_e3_gnn_torch``: see cli.py."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
