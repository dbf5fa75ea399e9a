"""`python -m tpu_viterbi_torch` == the reference CLI's simulation path
(same flags as `./main -n -s -i -m -o -c -v`, src/main.cpp:183-193)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
