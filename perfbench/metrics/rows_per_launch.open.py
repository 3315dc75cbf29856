"""Latent rows of real requests a segment launch carried (pack rows less
pad rows, over launches), from the window's start to its close, the drain
left out: how well the tick loop packs groups into one graph replay."""


def read(run):
    s = run.window.stats
    if not s.get("launches"):
        return None
    return (s["pack_rows"] - s["pack_pad_rows"]) / s["launches"]
