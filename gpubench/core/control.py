"""The upper readings: the check's numbers for the control (the plain
reference computed in float8 e4m3, the precision below the
configuration's bf16, put in the program's place) and for the planted
faults, each against the reference (the configuration's own bf16
products, float32 sums), at the cell's own size, on the same inputs a
run of that seed makes; each loop (gpubench/loops/<kind>.py) reads its
own. A state left unchanged reads 1 by the training measure and needs no
run.
"""

from __future__ import annotations

import torch

from gpubench.core import cell as C


def read(workload: str, seeds, dev, overrides: dict | None = None) -> dict:
    _, cfg, traffic = C.load_cell(workload, overrides)
    ref = C.system_of(cfg).reference
    loop = C.loop_of(traffic)
    out = {}
    for seed in seeds:
        out[seed] = loop.control(ref, cfg, traffic, seed, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"workload": workload, "control": out}
