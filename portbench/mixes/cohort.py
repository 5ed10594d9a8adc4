"""A cohort on one card: `batch` host volumes a call through
``sift3d_torch.extract_features_many``, back to back, cycling through
`distinct` distinct volumes. A unit is one call; it counts its volumes."""

from __future__ import annotations

import extraction
from sift3d_torch import extract_features_many


def setup(config, params, seed, devices, say):
    first = [j % params["distinct"] for j in range(params["batch"])]  # the first call's batch
    state = extraction.setup(config, params, seed, devices, say, params["distinct"], groups=[first])
    state["next"] = 0
    return state


def _call(state, spans):
    p, n = state["params"], state["params"]["distinct"]
    ids = [(state["next"] + j) % n for j in range(p["batch"])]
    state["next"] = (state["next"] + p["batch"]) % n
    out = extract_features_many([state["vols"][i] for i in ids], state["cfg"], device=state["devices"][0],
                                timer=spans.timer, descriptor=state["config"]["descriptor"])
    return ids, out


def warmup(state, spans):
    ids, out = _call(state, spans)
    extraction.report_counts(state, out)
    state["next"] = 0


def unit(state, spans):
    ids, out = _call(state, spans)
    extraction.keep(state, ids, out)
    return len(ids)


check = extraction.check
