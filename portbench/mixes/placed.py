"""A cohort on a node of cards: `batch` host volumes a call through
``sift3d_torch.extract_features_batch`` over the cell's devices, back to
back, cycling through `distinct` distinct volumes. The placement deals a
call's volumes round-robin, one group a card, and each card extracts its
group as one batch in a host thread of its own. A unit is one call; it
counts its volumes.

The harness's timer is not passed: it synchronizes every card at each
stage, which would serialize the cards. In a traced run the placement's
own spans (``place``, ``place_tail``) name its host time."""

from __future__ import annotations

import extraction
from sift3d_torch import extract_features_batch


def groups(ids, cards: int):
    """The placement's round-robin groups of one call's volumes."""
    n = min(cards, len(ids))
    return [ids[e::n] for e in range(n)]


def _next_ids(state):
    p, n = state["params"], state["params"]["distinct"]
    ids = [(state["next"] + j) % n for j in range(p["batch"])]
    state["next"] = (state["next"] + p["batch"]) % n
    return ids


def setup(config, params, seed, devices, say):
    first = [j % params["distinct"] for j in range(params["batch"])]  # the first call's volumes
    state = extraction.setup(config, params, seed, devices, say, params["distinct"],
                             groups=groups(first, len(devices)))
    state["next"] = 0
    return state


def _call(state):
    ids = _next_ids(state)
    out = extract_features_batch([state["vols"][i] for i in ids], state["devices"], state["cfg"],
                                 descriptor=state["config"]["descriptor"])
    return ids, out


def warmup(state, spans):
    ids, out = _call(state)
    extraction.report_counts(state, out)
    state["next"] = 0


def unit(state, spans):
    ids, out = _call(state)
    extraction.keep(state, ids, out)
    return len(ids)


check = extraction.check
