"""A cell at smoke size for the CPU tests: the configuration of
``configs/dit-b2.json`` with every size cut down and computed in float32
(so that the program and the reference differ by rounding alone, and the
image limit can be tight), its offline and open traffic, and the metric
lists of the real cells."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

UNITS = {"images_per_s": "images/s", "setup_s": "s", "latency_p95_s": "s",
         "nfe_per_image.offline": "rows/image",
         "nfe_per_image.open": "rows/image", "rows_per_launch.open": "rows",
         "mfu.offline": "%", "attention_roofline": "%",
         "idle_share.offline": "%", "idle_share.open": "%"}
SEED = 2 ** 31 + 12345


def config() -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" / "dit-b2.json")
                     .read_text())
    cfg["model"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=128, latent_size=8, cond_dim=32,
                        cond_len=24)
    cfg["text"].update(n_layers=1, d_model=32, n_heads=2, d_ff=64)
    cfg["model"]["dtype"] = cfg["vae"]["dtype"] = "float32"
    cfg["sage"]["total_steps"] = 6
    return cfg


OFFLINE = {"loop": "offline", "batch": 8,
           "prompts": {"generator": "themed", "paraphrases": 4},
           "check": {"groups": 2, "rows": 8, "latent_l1_err": 1e-3,
                     "decode_rel_err": 1e-3}}
OPEN = {"loop": "open",
        "prompts": {"generator": "themed", "paraphrases": 4},
        "arrivals": {"generator": "poisson", "rate": 10.0, "stream": 1},
        "scheduler": {"slice_steps": 4, "max_wait_ticks": 2, "packed": True},
        "warm_groups": 2, "drain_cap_s": 20, "trace_s": 10,
        "check": {"groups": 3, "rows": 8, "latent_l1_err": 1e-3,
                  "decode_rel_err": 1e-3}}


def cell(loop: str = "offline"):
    from perfbench import harness
    if loop == "offline":
        return harness.Cell("smoke.offline", config(), copy.deepcopy(OFFLINE),
                            ["images_per_s", "setup_s"],
                            ["nfe_per_image.offline", "mfu.offline",
                             "attention_roofline", "idle_share.offline"],
                            UNITS)
    return harness.Cell("smoke.open", config(), copy.deepcopy(OPEN),
                        ["latency_p95_s", "setup_s"],
                        ["nfe_per_image.open", "rows_per_launch.open",
                         "idle_share.open"], UNITS)
