"""CLI entry: ``python -m ceph_tpu_torch.analysis [paths...]``."""
import sys

from .engine import main

if __name__ == "__main__":
    sys.exit(main())
