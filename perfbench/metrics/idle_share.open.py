"""Share of the traced window's load (its ``bench.load`` span: from the
window's start to its close, the drain left out) in which no device
activity ran (the reader of ``idle_share.offline``)."""
from perfbench.harness import load_part

read = load_part("metrics", "idle_share.offline").read
