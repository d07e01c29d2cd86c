"""``ops/nn.route``, the one place that picks the NN kernel, row by row
of its table, and ``NNIndex`` running each pick on the CPU (the kernels'
plain versions) bitwise ``nn_torch`` and the payload gather."""

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.ops import nn

F32_EPS = float(np.finfo(np.float32).eps)
AUTO = ICPConfig(nn_dst_tile=256)
CUDA = AUTO.with_(nn_backend="cuda")

# (query shape, db shape, payload width, config, matched, dtype, search:
# None (no bounds), "cold" (+inf bounds) or "warm" (valid bounds, warm
# True); then the route's kind, sort, pack and pruned_warm.)
CASES = {
    "sort-azimuth": ((300, 2), (1000, 2), 2,
                     AUTO.with_(nn_sort="azimuth"), True, torch.float32,
                     "warm", ("list", "azimuth", True, False)),
    "sort-morton-on-torch": ((300, 2), (1000, 2), 2,
                             AUTO.with_(nn_sort="morton",
                                        nn_backend="torch"),
                             True, torch.float32, None,
                             ("torch", "morton", False, False)),
    "sort-none": ((300, 2), (1000, 2), 2, AUTO.with_(nn_sort="none"), True,
                  torch.float32, "cold", ("list", None, True, False)),
    "mxu-auto": ((300, 3), (1000, 3), 3, AUTO.with_(nn_method="mxu"), True,
                 torch.float32, "warm", ("torch", None, False, False)),
    "mxu-cuda": ((300, 3), (1000, 3), 3, CUDA.with_(nn_method="mxu"), True,
                 torch.float32, "warm", ("list", "morton", True, False)),
    "float64-auto": ((300, 2), (1000, 2), 2, AUTO, True, torch.float64,
                     "warm", ("torch", None, False, False)),
    "list-unbounded": ((300, 3), (1000, 3), 4, AUTO, True, torch.float32,
                       None, ("list", "morton", True, False)),
    "list-spans-3-tiles": ((300, 2), (600, 2), 2, AUTO, True,
                           torch.float32, "warm",
                           ("list", None, True, False)),
    "wide-payload": ((300, 3), (1000, 3), 6, AUTO, True, torch.float32,
                     "warm", ("sweep", "morton", False, False)),
    "under-3-tiles": ((300, 2), (500, 2), 2, AUTO, True, torch.float32,
                      "warm", ("sweep", None, False, False)),
    "pairs": ((2, 200, 2), (2, 500, 2), 2, AUTO, True, torch.float32,
              "warm", ("pairs", "morton", False, False)),
    "pairs-under-3-chunks": ((2, 200, 3), (2, 300, 3), 4, AUTO, True,
                             torch.float32, "cold",
                             ("pairs", None, False, False)),
    "wide-db-cold": ((2, 100, 2), (2, 4600, 2), 2,
                     AUTO.with_(nn_dst_tile=1408), True, torch.float32,
                     "cold", ("sweep", "morton", False, True)),
    "wide-db-warm": ((2, 100, 3), (2, 4600, 3), 4,
                     AUTO.with_(nn_dst_tile=1408), True, torch.float32,
                     "warm", ("sweep", "morton", False, True)),
    "wide-db-under-3-tiles": ((2, 100, 2), (2, 4600, 2), 2,
                              AUTO.with_(nn_dst_tile=2048), True,
                              torch.float32, "warm",
                              ("sweep", None, False, False)),
    "unmatched-batched-small-auto": ((2, 200, 2), (2, 500, 2), 0, AUTO,
                                     False, torch.float32, None,
                                     ("torch", "morton", False, False)),
    "unmatched-batched-small-cuda": ((2, 200, 2), (2, 500, 2), 0, CUDA,
                                     False, torch.float32, None,
                                     ("sweep", "morton", False, False)),
    "unmatched-one-cloud": ((300, 3), (1000, 3), 0, AUTO, False,
                            torch.float32, None,
                            ("sweep", "morton", False, False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_table_and_index_search(case):
    qs, ds, p, cfg, matched, dtype, search, want = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    db = torch.as_tensor(rng.uniform(-3, 3, ds), dtype=dtype)
    mask = torch.as_tensor(rng.random(ds[:-1]) > 0.2)
    query = db[..., :qs[-2], :] + torch.as_tensor(
        rng.normal(0, 0.05, qs), dtype=dtype)
    route = nn.route(query, db, p, cfg, matched=matched)
    assert (route.kind, route.sort, route.pack, route.pruned_warm) == want
    payload = (torch.as_tensor(rng.normal(size=(*ds[:-1], p)), dtype=dtype)
               if matched else None)
    index = nn.NNIndex(route, db, mask, payload, cfg)
    assert (index.packed is not None) == route.pack
    method = cfg.nn_method if route.kind == "torch" else "direct"
    brute = nn.nn_torch(query, db, mask, method=method)
    kw = {}
    if search == "cold":
        kw = dict(q_bound=torch.full(qs[:-1], float("inf"), dtype=dtype),
                  warm=False)
    elif search == "warm":
        kw = dict(q_bound=brute.dist_sq * (1.0 + 32.0 * F32_EPS), warm=True)
    res, rows = index.search(query, **kw)
    assert torch.equal(res.index, brute.index)
    assert torch.equal(res.dist_sq, brute.dist_sq)
    if matched:
        assert torch.equal(rows, nn.gather_rows(payload, brute.index))
    else:
        assert rows is None
