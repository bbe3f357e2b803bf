"""`python -m sniffles_tpu_torch` entry point."""
import sys

from sniffles_tpu_torch.cli import main

# guarded: a spawned worker process imports this module as __mp_main__
if __name__ == "__main__":
    sys.exit(main())
