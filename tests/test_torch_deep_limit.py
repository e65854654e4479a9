"""Deep LIMITs through SQL in the port against the reference, on the
same rows through `turdb_tpu.Database` and
`turdb_tpu_torch.Database(device="cpu")`: `LIMIT 200` on a USING HNSW
index (the ANN path fetches 4 * LIMIT = 800 rows at ef 1600, past the
fast beam's ef of 1024 on the card) and `LIMIT 600` on a USING IVF index
(fetch 2400, past the probes' 2048 winners). Each engine answers with
LIMIT rows, and the port's recall@LIMIT against the exact path is within
RECALL_TOL of the reference's on the same queries."""

import pytest

from test_torch_vector_sql import RECALL_TOL, Pair, _data, _exact, _recalls, vec_lit


@pytest.mark.parametrize("using, limit, n", [("HNSW", 200, 900), ("IVF", 600, 2600)],
                         ids=["hnsw-200", "ivf-600"])
def test_deep_limit_answers_as_the_reference(using, limit, n, tmp_path):
    x, q = _data(seed=91, n=n)
    q = q[:3]
    pair = Pair(tmp_path, x)
    exact = _exact(pair, q, limit=limit)
    pair.both(f"CREATE INDEX ix ON docs USING {using} (emb)")
    for v in q:
        a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(v)} LIMIT {limit}")
        assert len(a) == len(b) == limit
    ref_r, port_r = _recalls(pair, q, exact, limit=limit)
    assert port_r >= ref_r - RECALL_TOL, (ref_r, port_r)
    pair.close()
