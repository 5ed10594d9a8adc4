"""One scan at a time: a closed loop with one client calling
``sift3d_torch.extract_features`` on one host volume, cycling through
`distinct` distinct volumes. A unit is one volume, from the call to its
FeatureSet on the host. The volumes are visited in an order drawn from
the seed."""

from __future__ import annotations

import extraction
from sift3d_torch import extract_features


def setup(config, params, seed, devices, say):
    state = extraction.setup(config, params, seed, devices, say, params["distinct"])
    state["next"] = 0
    return state


def _call(state, spans, i):
    return extract_features(state["vols"][i], state["cfg"], device=state["devices"][0], timer=spans.timer,
                            descriptor=state["config"]["descriptor"])


def warmup(state, spans):
    n = min(state["params"]["warmup_volumes"], state["params"]["distinct"])
    extraction.report_counts(state, [_call(state, spans, i) for i in state["order"][-n:]])


def unit(state, spans):
    """The next volume of the seed's order."""
    k = state["next"]
    state["next"] = (k + 1) % state["params"]["distinct"]
    i = state["order"][k]
    extraction.keep(state, [i], [_call(state, spans, i)])
    return 1


check = extraction.check
