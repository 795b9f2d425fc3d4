"""`python -m ngmlr_tpu` — the reference binary's entry point
(ngmlr src/main.cpp:60-115)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
