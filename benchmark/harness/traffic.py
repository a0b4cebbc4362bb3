"""The one traffic generator: reads a traffic mix and draws requests from
the seed.

A mix lists its `requests`, each a list of point loads {"x", "y", "z",
"fx", "fy", "fz"} (positions in m, forces in N), as its source documents
them; every request of the stream is drawn uniformly from that list. The
same seed gives the same requests; the warm-up requests come from a stream
of their own. The model embeds the positions of every load of the mix.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def _entropy(seed: int) -> int:
    """Any whole number, as the non-negative entropy numpy's seeding takes."""
    return int(seed) % (1 << 64)


def _stream(seed: int, key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([_entropy(seed), key]))


def _request(rng: np.random.Generator, mix: dict) -> List[dict]:
    req = mix["requests"][int(rng.integers(len(mix["requests"])))]
    return [dict(p) for p in req]


def requests(seed: int, mix: dict) -> Iterator[List[dict]]:
    """The endless stream of requests of `seed`."""
    rng = _stream(seed, 0)
    while True:
        yield _request(rng, mix)


def warmup_requests(seed: int, mix: dict, n: int) -> List[List[dict]]:
    """`n` requests for set-up, from a stream apart from the timed one."""
    rng = _stream(seed, 1)
    return [_request(rng, mix) for _ in range(n)]


def traced_request(seed: int, mix: dict) -> List[dict]:
    """The request a traced run sends after its window."""
    return _request(_stream(seed, 3), mix)


def load_points(mix: dict) -> List[Tuple[float, float, float]]:
    """The distinct positions of the mix's loads, in their first order."""
    out: List[Tuple[float, float, float]] = []
    for req in mix["requests"]:
        for p in req:
            xyz = (float(p["x"]), float(p["y"]), float(p["z"]))
            if xyz not in out:
                out.append(xyz)
    return out


def model_rng(seed: int) -> np.random.Generator:
    """The stream the model's own random parts come from (the node
    relabelling of the mesh-file route)."""
    return _stream(seed, 2)
