"""Themed text-to-image prompts: a theme is a subject in a setting, light
and style, and its prompts are paraphrases of it (other adjectives, other
word order), as users who ask for variations of one idea write them.

``prompts(params, rng, n)`` gives ``n`` prompts, ``params["paraphrases"]``
consecutive ones a theme, all distinct and at most 75 bytes long (a
77-token context less BOS and EOS).  ``rng`` is a
``numpy.random.Generator`` drawn from the run's seed."""
from __future__ import annotations

SUBJECTS = ("red fox", "lighthouse", "steam train", "paper boat", "old oak",
            "snow leopard", "glass teapot", "windmill", "koi pond",
            "hot air balloon", "cathedral", "vintage car", "sea turtle",
            "mountain cabin", "tabby cat", "sunflower field", "robot",
            "violin", "desert caravan", "stone bridge", "owl", "sailboat",
            "bonsai tree", "market stall", "jellyfish", "castle ruin",
            "bicycle", "waterfall", "astronaut", "coffee cup")
SETTINGS = ("on a misty hill", "by a frozen lake", "in a busy harbour",
            "in a quiet forest", "on a city rooftop", "in a wheat field",
            "under a stone arch", "beside a river", "in a snowy valley",
            "on a sandy beach", "in a neon alley", "in a flower garden",
            "on a rocky coast", "in a library", "above the clouds")
LIGHTS = ("dawn", "dusk", "noon", "midnight", "golden hour", "blue hour",
          "overcast light", "moonlight")
STYLES = ("oil painting", "watercolor", "pencil sketch", "photograph",
          "digital art", "ink drawing", "pastel drawing", "3d render")
ADJS = ("small", "large", "lonely", "bright", "ancient", "tiny", "majestic",
        "quiet", "colorful", "weathered")
TEMPLATES = ("a {adj} {subject} {setting} at {light}, {style}",
             "{style} of a {adj} {subject} {setting}, {light}",
             "a {subject}, {adj} and {setting}, {light}, {style}",
             "{light}: a {adj} {subject} {setting} as a {style}",
             "a {style} showing a {adj} {subject} {setting} at {light}",
             "the {adj} {subject} {setting}, {style}, {light}")


def theme(rng) -> dict:
    return {"subject": SUBJECTS[rng.integers(len(SUBJECTS))],
            "setting": SETTINGS[rng.integers(len(SETTINGS))],
            "light": LIGHTS[rng.integers(len(LIGHTS))],
            "style": STYLES[rng.integers(len(STYLES))]}


MAX_BYTES = 75


def paraphrases(rng, th: dict, k: int, tries: int = 200):
    """``k`` distinct paraphrases of theme ``th`` (fewer if ``tries`` draws
    do not find them)."""
    out = []
    for _ in range(tries):
        if len(out) == k:
            break
        s = TEMPLATES[rng.integers(len(TEMPLATES))].format(
            adj=ADJS[rng.integers(len(ADJS))], **th)
        if s not in out and len(s.encode()) <= MAX_BYTES:
            out.append(s)
    return out


def prompts(params: dict, rng, n: int):
    k = int(params["paraphrases"])
    out = []
    while len(out) < n:
        ps = paraphrases(rng, theme(rng), k)
        if len(ps) < k:
            continue
        for s in ps:
            if s not in out and len(out) < n:
                out.append(s)
    return out
