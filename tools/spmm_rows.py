#!/usr/bin/env python3
"""Time the single-matrix spmm rows of a checkout, to hold a change of
``csrc/bsr_spmm.cu`` against its parent on one card.

    python3 tools/spmm_rows.py time ROOT TAG >> rows.log
    python3 tools/spmm_rows.py compare rows.log

``time`` builds ``csrc/bsr_spmm.cu`` of the checkout at ROOT and runs its
``chip_smoke.py``'s kernel and decode phases (both forward kernels at
smollm-360m's projections, M = 4 and 512, f32 and bf16 x, the f32 store,
palette-8 and palette-4; the decode kernel at M = 1-16), printing one JSON
line per timed row tagged TAG. Run it for the parent (unpacked with ``git
archive`` into a directory ``.gitignore`` lists, such as ``build/parent``)
and the change in turns in one call on the card: parent, change, change,
parent. ``compare`` prints, over the rows both trees timed twice, the
median and range of change / parent and each tree's own spread.
"""
from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def time_rows(root: str, tag: str) -> None:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    cs._build.build_all(("bsr_spmm",))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    cs.log = lambda *a: lines.append(" ".join(map(str, a)))
    cs.kernel_phase(dev)
    cs.decode_phase(dev)
    for line in lines:
        if line.startswith("{"):
            row = json.loads(line)
            print(json.dumps({"tree": tag, **{
                k: row.get(k) for k in ("kernel", "matrix", "M", "x", "store",
                                        "ms", "ms_decode", "ms_tile")}}))


def compare(path: str) -> None:
    times = defaultdict(list)
    for line in open(path):
        row = json.loads(line)
        if "kernel" not in row:            # the launch-floor lines
            continue
        key = (row["kernel"], row["matrix"], row["M"], row["x"], row["store"])
        for k in ("ms_decode", "ms_tile", "ms"):
            if row.get(k) is not None and not (k == "ms" and row.get("ms_decode")):
                times[key + (k,)].append((row["tree"], row[k]))
    ratios, spread = [], {"parent": [], "change": []}
    for key, vals in times.items():
        by = {t: [v for tag, v in vals if tag == t] for t in spread}
        if all(len(v) == 2 for v in by.values()):
            ratios.append(statistics.mean(by["change"])
                          / statistics.mean(by["parent"]))
            for t, v in by.items():
                spread[t].append(abs(v[0] - v[1]) / min(v))
    print(f"{len(ratios)} rows: change / parent median "
          f"{statistics.median(ratios):.4f}, range {min(ratios):.4f}-"
          f"{max(ratios):.4f}; own spread (median, max): " + ", ".join(
              f"{t} {statistics.median(v):.4f} {max(v):.4f}"
              for t, v in spread.items()))


if __name__ == "__main__":
    if sys.argv[1:2] == ["time"]:
        time_rows(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["compare"]:
        compare(sys.argv[2])
    else:
        raise SystemExit(__doc__)
