#!/usr/bin/env python3
"""Compare the digits of two ``chip_smoke.py`` outputs, times masked.

    python3 scripts/smoke_digits.py PARENT.out CHANGE.out [--last-phase N]

Keeps each output's lines from ``phase 1`` up to the first line of a phase
above N (default 63) or the JSON lines at the end, masks what a run's
timing decides (a number before ``ms``, ``s`` or ``µs``; a ratio
``(1.83x)``; a percentage; the times printed without a unit: ``(unsharded
0.865)``, ``single run 240.2``, a ``times [...]`` list, the ``walls (s):``
line; the build's hash in the library's name; the ``total`` line) and
prints a unified diff of the masked lines and, last, the number of lines
that differ.  Every other digit (errors, iterations, weights, PSNR, costs,
device operations, counts) is compared as printed.
"""

import difflib
import re
import sys

TIME = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?\s*(?:ms|µs|us|s)\b")
RATIO = re.compile(r"\d+(?:\.\d+)?x\b")
PERCENT = re.compile(r"\d+(?:\.\d+)?%")
HASH = re.compile(r"libbpl_kernels_[0-9a-f]+")
# times printed without a unit
BARE = ((re.compile(r"\(unsharded \d+(?:\.\d+)?\)"), "(unsharded <t>)"),
        (re.compile(r"single run \d+(?:\.\d+)?"), "single run <t>"),
        (re.compile(r"times \[[^\]]*\]"), "times [<t>]"),
        (re.compile(r"walls \(s\):[^;]*"), "walls (s): <t>"))
PHASE = re.compile(r"^phase (\d+)\b")


def masked(path, last):
    out, on = [], False
    for line in open(path, encoding="utf-8", errors="replace"):
        m = PHASE.match(line)
        if m:
            on = int(m.group(1)) <= last
        if line.startswith("{"):
            on = False
        if not on or line.lstrip().startswith("total "):
            continue
        line = HASH.sub("libbpl_kernels_<hash>", line.rstrip("\n"))
        for pattern, mask in BARE:
            line = pattern.sub(mask, line)
        line = TIME.sub("<t>", line)
        line = RATIO.sub("<r>x", line)
        out.append(PERCENT.sub("<p>%", line))
    return out


def main(argv):
    last = 63
    if "--last-phase" in argv:
        i = argv.index("--last-phase")
        last = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (masked(p, last) for p in argv)
    diff = [line for line in difflib.unified_diff(a, b, argv[0], argv[1],
                                                  lineterm="", n=0)]
    for line in diff:
        print(line)
    changed = sum(1 for line in diff if line[:1] in "+-"
                  and not line.startswith(("+++", "---")))
    print(f"{len(a)} and {len(b)} masked lines of phases 1-{last}; "
          f"{changed} differ")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
