"""Lint: no bare ``print(`` in ray_tpu_torch/_private/.

The port's copy of the reference's print lint, over the port's own
runtime (``ray_tpu_torch/_private``).

Runtime/control-plane code must use ``logging`` — a bare print from a
raylet/GCS/worker internals lands in the worker log stream unleveled and
unattributable, and (worse) in drivers it interleaves with the streamed
cluster logs. Enforced as a fast tier-1 test (tests/test_torch_logs.py).

Allowed escapes:
  - an explicit destination on the same line (``print(..., file=sys.stderr)``)
    — deliberate out-of-band diagnostics;
  - a ``# lint: allow-print`` annotation — deliberate stdout protocol
    output (CLI tables, port announcements consumed by parents).

Usage: python -m ray_tpu_torch.tools.lint_print [root]
(exits 1 on violations)
"""

from __future__ import annotations

import os
import re
import sys

# backtick in the lookbehind skips ``print()`` doc references
PRINT_RE = re.compile(r"(?<![\w.\"'`])print\(")
ALLOW_MARK = "# lint: allow-print"


def check_file(path: str) -> list:
    violations = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            stripped = line.strip()
            if stripped.startswith("#"):
                continue
            if not PRINT_RE.search(line):
                continue
            if "file=" in line or ALLOW_MARK in line:
                continue
            violations.append((path, lineno, stripped))
    return violations


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    root = argv[0] if argv else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "_private",
    )
    violations = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for name in sorted(filenames):
            if name.endswith(".py"):
                violations.extend(check_file(os.path.join(dirpath, name)))
    for path, lineno, line in violations:
        print(f"{path}:{lineno}: bare print() — use logging, or add "  # lint: allow-print
              f"file=/{ALLOW_MARK!r} if deliberate: {line[:80]}")
    if violations:
        return 1
    print(f"lint_print: OK ({root})")  # lint: allow-print
    return 0


if __name__ == "__main__":
    sys.exit(main())
