"""Run a command and write each line of its standard output, prefixed with
the seconds since the command started, to a file; print the command's
last lines as they are and exit with its code.

    python3 timed_lines.py OUT_FILE -- python3 chip_smoke.py

Used to compare where two trees' ``chip_smoke.py`` spend their time when
one of them prints no wall of its own for a phase: the gap between two
lines is the time the script took between them.
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(argv) -> int:
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    out_path, cmd = argv[0], argv[2:]
    t0 = time.perf_counter()
    tail = []
    with open(out_path, "w") as out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True, bufsize=1) as proc:
        for line in proc.stdout:
            out.write(f"{time.perf_counter() - t0:10.3f} {line}")
            out.flush()
            tail = (tail + [line])[-3:]
    sys.stdout.write("".join(tail))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
