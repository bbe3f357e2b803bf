"""`python -m sniffles_tpu_torch` entry point."""
import sys

from sniffles_tpu_torch.cli import main

sys.exit(main())
