"""The tag line a WD tagger writes for one image, from its probabilities, in
plain numpy (the original app's tagging.py semantics):

  MCut threshold of a category: sort the category's probabilities in
  descending order, take the first largest gap between neighbours, and
  threshold at its midpoint (f32 arithmetic). Character threshold: max(MCut,
  0.15); 0.3 where MCut is off. A tag is kept when its probability, as f64, is above the threshold;
  kept tags are ordered by probability, descending (ties in label order),
  spaces become underscores; general tags, then ``,`` and the character tags
  when there are any.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def mcut(p: np.ndarray) -> np.float32:
    s = np.sort(np.asarray(p, np.float32))[::-1]
    gaps = s[:-1] - s[1:]
    t = int(np.argmax(gaps))
    return np.float32((s[t] + s[t + 1]) / np.float32(2))


def _kept(names: Sequence[str], p: np.ndarray, thresh: np.float32) -> List[str]:
    p64 = np.asarray(p, np.float32).astype(np.float64)
    idx = [i for i in range(len(p64)) if p64[i] > float(thresh)]
    idx.sort(key=lambda i: -p64[i])
    return [names[i].replace(" ", "_") for i in idx]


def line(probs: np.ndarray, names: Sequence[str], categories: np.ndarray, cfg: dict) -> str:
    """The text after ``path,`` for one image's (classes,) f32 probabilities."""
    s = cfg["serve"]
    gen = np.where(categories == 0)[0]
    char = np.where(categories == 4)[0]
    g_names = [names[i] for i in gen]
    c_names = [names[i] for i in char]
    g_t = mcut(probs[gen]) if s["general_mcut"] else 0.3
    c_t = (max(mcut(probs[char]), np.float32(s["character_floor"]))
           if s["character_mcut"] else 0.3)
    out = ",".join(_kept(g_names, probs[gen], g_t))
    chars = _kept(c_names, probs[char], c_t)
    if chars:
        out += "," + ",".join(chars)
    return out
