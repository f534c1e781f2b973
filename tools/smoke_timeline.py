"""Run ``chip_smoke.main()`` with every line it prints prefixed by the
seconds since the start, then list the longest stretches between two
lines: where the script's time goes, for cutting its depth.

Run from the repository root on a machine with the card, for example
``python3 -u tools/smoke_timeline.py > chiprun_out/timeline.log``.
A failing phase raises as it does in ``chip_smoke.py``.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

#: stretches listed at the end
LONGEST = 20


def main() -> None:
    t0 = time.perf_counter()
    stamps = []

    def stamped(*args, **kwargs):
        t = time.perf_counter() - t0
        stamps.append((t, " ".join(str(a) for a in args)[:120]))
        print(f"[{t:8.1f}]", *args, **kwargs)

    chip_smoke.print = stamped
    chip_smoke.main()
    gaps, prev = [], 0.0
    for t, text in stamps:
        gaps.append((t - prev, t, text))
        prev = t
    print(f"total {prev:.1f} s; the {LONGEST} longest stretches, each "
          f"ending at the line shown:")
    for gap, t, text in sorted(gaps, reverse=True)[:LONGEST]:
        print(f"{gap:7.1f} s, ending at {t:7.1f} s: {text}")


if __name__ == "__main__":
    main()
