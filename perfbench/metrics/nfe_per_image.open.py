"""Denoiser rows the scheduler ran per served image from the window's
start to its close, the drain left out, under the tick loop (the reader of
``nfe_per_image.offline``)."""
from perfbench.harness import load_part

read = load_part("metrics", "nfe_per_image.offline").read
