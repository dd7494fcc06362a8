"""Lint: no per-call allocations in the control-plane hot sections.

The port's copy of the reference's hot-section lint, over the port's own
marked files (``ray_tpu_torch/_private/worker.py`` and ``rpcio.py``).

The submit->lease->dispatch fast path got its wins by hoisting
constant work out of the per-call loop: spec templates instead of per-call
``dict(`` copies, block-minted binary ids instead of f-string hex ids.
Those regressions creep back one innocuous line at a time, so the hot
sections are MARKED in the source::

    # hotpath: begin <name>
    ...
    # hotpath: end <name>

and this lint (a fast tier-1 test, tests/test_torch_control_plane.py)
forbids, inside any marked region:

  - ``dict(`` — a per-call dict copy; build the dict once in the template
    or pass the original through (specs share the template's resources
    map by design);
  - f-strings — per-call string formatting; ids are raw bytes
    (``TaskIDMinter`` / ``object_id_binary``), stage tags are precomputed.

Error paths inside a region escape with ``# lint: allow-hotpath (why)`` —
a raise that fires once per failure may format all it wants.

A file listed in HOT_FILES with no marked region FAILS: the markers are
the contract, and a refactor that drops them silently disables the lint.

Usage: python -m ray_tpu_torch.tools.lint_hotpath [file ...]
(exits 1 on violations)
"""

from __future__ import annotations

import os
import re
import sys

BEGIN_RE = re.compile(r"#\s*hotpath:\s*begin\b")
END_RE = re.compile(r"#\s*hotpath:\s*end\b")
ALLOW_MARK = "# lint: allow-hotpath"
# bare dict( call — not .dict(, not OrderedDict(, not "dict(" in a string
DICT_RE = re.compile(r"(?<![\w.\"'`])dict\(")
FSTRING_RE = re.compile(r"""(?<![\w"'])[fF][rRbB]?["']""")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOT_FILES = (
    os.path.join(_PACKAGE, "_private", "worker.py"),
    os.path.join(_PACKAGE, "_private", "rpcio.py"),
)


def check_file(path: str) -> list:
    violations = []
    regions = 0
    inside = False
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            stripped = line.strip()
            if BEGIN_RE.search(line):
                if inside:
                    violations.append(
                        (path, lineno, "nested 'hotpath: begin' (missing "
                         "an 'end'?)"))
                inside = True
                regions += 1
                continue
            if END_RE.search(line):
                if not inside:
                    violations.append(
                        (path, lineno, "'hotpath: end' without a 'begin'"))
                inside = False
                continue
            if not inside or stripped.startswith("#") \
                    or ALLOW_MARK in line:
                continue
            if DICT_RE.search(line):
                violations.append(
                    (path, lineno, f"per-call dict( copy in hot section: "
                     f"{stripped[:80]}"))
            if FSTRING_RE.search(line):
                violations.append(
                    (path, lineno, f"f-string in hot section: "
                     f"{stripped[:80]}"))
    if inside:
        violations.append((path, lineno, "unterminated 'hotpath: begin'"))
    if regions == 0:
        violations.append(
            (path, 0, "no '# hotpath: begin' regions found — the markers "
             "are the lint contract; restore them"))
    return violations


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    paths = argv if argv else list(HOT_FILES)
    violations = []
    for path in paths:
        violations.extend(check_file(path))
    for path, lineno, msg in violations:
        print(f"{path}:{lineno}: {msg}")  # lint: allow-print
    if violations:
        return 1
    print(f"lint_hotpath: OK ({len(paths)} files)")  # lint: allow-print
    return 0


if __name__ == "__main__":
    sys.exit(main())
