"""Every kernel's compiled code against another checkout's build.

    python -m tpu_viterbi_torch.scripts.sass_compare OTHER_CHECKOUT

builds this tree's library and OTHER_CHECKOUT's (that tree's own
``tpu_viterbi_torch.library.load_library``, run in its directory), reads
each kernel's SASS instructions, their digest, registers and stack from
both (``common.sass_digests``) and prints how many of the other build's
kernels compiled to the same code here, and the names of those that differ
or are gone.  Exits 0 when every one of them is the same, 1 otherwise (as
``cmp``).  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List, Tuple

from .common import sass_digests

MARKER = "viterbi"      # every kernel's namespace: all cubins of a build


def other_library(checkout: str) -> str:
    """The path of the library that ``checkout``'s sources build."""
    out = subprocess.run(
        [sys.executable, "-c", "from tpu_viterbi_torch.library import "
         "load_library; print(load_library()._name)"],
        cwd=checkout, capture_output=True, text=True, check=True)
    return out.stdout.split()[-1]


def compare(mine: Dict[str, tuple], theirs: Dict[str, tuple]
            ) -> Tuple[List[str], List[str], List[str]]:
    """(the same, differing, gone): the names of ``theirs``' kernels whose
    digest entry in ``mine`` is equal, is not, or is missing."""
    same = [k for k in theirs if mine.get(k) == theirs[k]]
    differ = [k for k in theirs if k in mine and mine[k] != theirs[k]]
    gone = [k for k in theirs if k not in mine]
    return same, differ, gone


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    theirs = sass_digests(MARKER, other_library(args[0]))
    mine = sass_digests(MARKER)
    same, differ, gone = compare(mine, theirs)
    print(f"{args[0]}: {len(theirs)} kernels, this tree {len(mine)}; "
          f"the same SASS, registers and stack {len(same)}; differ "
          f"{len(differ)} {differ}; gone {len(gone)} {gone}")
    return 0 if len(same) == len(theirs) else 1


if __name__ == "__main__":
    sys.exit(main())
