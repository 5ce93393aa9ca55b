"""The port's collective cost model (`tpuasr_torch.parallel.scaling`)
against the JAX package's (`tpuasr/parallel/scaling.py`).

- `comm_report`, `predict` and `rescale_for_hosts` give the JAX functions'
  results exactly on the same seeded `Collective` lists (all-reduce,
  all-gather, collective-permute, all-to-all; groups inside one host and
  across hosts; every host count the JAX tool extrapolates to).
- Reduce-scatter follows the corrected formula, (c-1)/c·p·g on the links
  inside a host and (h-1)/h·p·g across hosts, held on a case computed by
  hand (JAX divides the two by h and by c).
- `record_collectives` notes nothing with no context open and every note in
  each open context; `relayout` puts a model group and a data group of the
  recorded world where a wider world has them; the scaling tool's rows and
  table.
The collectives a real step records are held in
tests/test_torch_parallel_dist.py (the "dp" layout's gradient all-reduce is
the flat gradient's bytes plus the metrics vector's).
"""

import numpy as np
import pytest
import torch

from tpuasr.parallel import scaling as jax_scaling
from tpuasr_torch.parallel import scaling
from tpuasr_torch.tools import scaling_predict

torch.set_num_threads(1)  # six test workers share the cores

OPS = ("all-reduce", "all-gather", "collective-permute", "all-to-all")


def _lists(seed: int, chips: int, hosts: int, n: int = 40):
    """Seeded collectives over chips x hosts ranks as (port, JAX) lists:
    groups that partition the ranks, inside a host or spanning hosts."""
    rng = np.random.default_rng(seed)
    world = chips * hosts
    port, jax = [], []
    for _ in range(n):
        op = OPS[rng.integers(len(OPS))]
        ids = np.arange(world)
        kind = rng.integers(3)
        if op == "collective-permute":
            groups = [[int(a), int(b)] for a, b in zip(ids, np.roll(ids, chips))]
        elif kind == 0:  # inside each host
            groups = ids.reshape(hosts, chips).tolist()
        elif kind == 1:  # one chip of each host
            groups = ids.reshape(hosts, chips).T.tolist()
        else:
            groups = [ids.tolist()]
        payload = int(rng.integers(1, 1 << 28))
        port.append(scaling.Collective(op, payload, groups))
        jax.append(jax_scaling.Collective(op, payload, groups))
    return port, jax


@pytest.mark.parametrize("chips,hosts", [(4, 1), (4, 2), (8, 2), (2, 4)])
def test_costs_match_jax(chips, hosts):
    port, jax = _lists(chips * 10 + hosts, chips, hosts)
    for c_p, c_j in zip(port, jax):  # one collective at a time, then all together
        a, b = scaling.comm_report([c_p], chips, hosts), jax_scaling.comm_report([c_j], chips,
                                                                                 hosts)
        assert (a.ici_bytes, a.dcn_bytes, a.by_op) == (b.ici_bytes, b.dcn_bytes, b.by_op)
    for target in (1, 2, 4, 8):
        sp = scaling.rescale_for_hosts(port, chips, hosts, target)
        sj = jax_scaling.rescale_for_hosts(jax, chips, hosts, target)
        assert [(c.op, c.payload, c.groups) for c in sp] == \
            [(c.op, c.payload, c.groups) for c in sj]
        for ms in (9.0, 174.9):
            got = scaling.predict(sp, chips, target, ms, 45.0, 25.0)
            assert got == jax_scaling.predict(sj, chips, target, ms, 45.0, 25.0)
    # the port's own link defaults (assumptions): NVLink 450 GB/s, NICs 400 GB/s a host
    got = scaling.predict(port, chips, hosts, 10.0)
    want = jax_scaling.predict(jax, chips, hosts, 10.0, scaling.NVLINK_GBPS, scaling.NIC_GBPS)
    assert got == want


def test_reduce_scatter_corrected_formula():
    # 16 ranks, 8 a host: a group of 4 chips on each of 2 hosts, 2 MB a rank
    # out, so 16 MB in; (c-1)/c·pin = 12 MB a GPU, (h-1)/h·pin = 8 MB a host
    # (JAX: 6 MB and 2 MB)
    grp = [0, 1, 2, 3, 8, 9, 10, 11]
    c = [scaling.Collective("reduce-scatter", 2_000_000, [grp])]
    rep = scaling.comm_report(c, 8, 2)
    pin = 2_000_000 * 8
    assert rep.ici_bytes == 3 / 4 * pin == 12_000_000
    assert rep.dcn_bytes == 1 / 2 * pin == 8_000_000
    jrep = jax_scaling.comm_report([jax_scaling.Collective("reduce-scatter", 2_000_000, [grp])],
                                   8, 2)
    assert (jrep.ici_bytes, jrep.dcn_bytes) == (6_000_000, 2_000_000)
    # inside one host: no NIC bytes
    one = scaling.comm_report([scaling.Collective("reduce-scatter", 1000, [[0, 1, 2, 3]])], 8, 1)
    assert (one.ici_bytes, one.dcn_bytes) == (3000.0, 0.0)
    row = scaling.predict(c, 8, 2, 10.0, ici_gbps=100.0, dcn_gbps=50.0)
    assert row["t_ici_ms"] == pytest.approx(12e6 / 100e9 * 1e3)
    assert row["t_dcn_ms"] == pytest.approx(8e6 / 50e9 * 1e3)
    assert row["eff_no_overlap"] == pytest.approx(10.0 / (10.0 + 0.12 + 0.16))


def test_recorder_notes_only_inside_a_context():
    assert not scaling.recording()
    scaling.note("all-reduce", 8, [0, 1])  # nothing is open: dropped
    with scaling.record_collectives() as outer:
        assert scaling.recording()
        scaling.note("all-reduce", 8, [0, 1])
        with scaling.record_collectives() as inner:
            scaling.note("all-gather", 32, (0, 2))
        scaling.note("all-reduce", 4, [1, 3])
    assert not scaling.recording()
    assert [(c.op, c.payload, c.groups) for c in outer] == [
        ("all-reduce", 8, [[0, 1]]), ("all-gather", 32, [[0, 2]]), ("all-reduce", 4, [[1, 3]])]
    assert [(c.op, c.payload, c.groups) for c in inner] == [("all-gather", 32, [[0, 2]])]


def test_one_rank_records_nothing():
    from tpuasr_torch.parallel.mesh import all_gather_flat, all_reduce

    x = torch.arange(4.0)
    with scaling.record_collectives() as got:
        assert all_reduce(x, None) is x
        assert torch.equal(all_gather_flat(x, None, 1), x)
    assert got == []


def test_relayout():
    Col = scaling.Collective
    # 4 ranks as 2 data x 2 model: rank 0's model group [0, 1], data group [0, 2]
    rec = [Col("all-reduce", 10, [[0, 1]]), Col("all-reduce", 20, [[0, 2]]),
           Col("all-gather", 30, [[0, 2]])]
    got = scaling.relayout(rec, 4, 2, 16)
    assert [(c.op, c.payload, c.groups) for c in got] == [
        ("all-reduce", 10, [[0, 1]]), ("all-reduce", 20, [list(range(0, 16, 2))]),
        ("all-gather", 30, [list(range(0, 16, 2))])]
    # one model rank: the data group is every rank; laid over a model axis
    # of 2, every other rank
    got = scaling.relayout([Col("all-reduce", 8, [[0, 1]])], 2, 1, 8)
    assert got[0].groups == [list(range(8))]
    got = scaling.relayout([Col("all-reduce", 8, [[0, 1]])], 2, 1, 8, 2)
    assert got[0].groups == [[0, 2, 4, 6]]


def test_tool_rows_and_table():
    colls = [scaling.Collective("all-reduce", 80_000_000, [list(range(8))]),
             scaling.Collective("all-reduce", 8, [list(range(8))])]
    rows = scaling_predict.prediction_rows(colls, 4, 2, [2, 4], 100.0, 450.0, 400.0)
    assert [r["hosts"] for r in rows] == [2, 4]
    # 2 hosts: NVLink 2·3/4·p a GPU, NICs 2·1/2·p a host
    assert rows[0]["ici_mb"] == pytest.approx(2 * 0.75 * 80.000008)
    assert rows[0]["dcn_mb"] == pytest.approx(80.000008)
    assert rows[1]["dcn_mb"] == pytest.approx(2 * 0.75 * 80.000008)  # 4 hosts
    results = {"dp": {"n_collectives": 2, "ops": ["all-reduce"], "rows": rows}}
    text = scaling_predict.table(results, 100.0, "given", 450.0, 400.0)
    assert "== dp (2 collectives: all-reduce) ==" in text and "assumptions" in text
    assert len(text.splitlines()) == 6
    cfg, stage, mp = scaling_predict.layout_config(scaling_predict.base_config(), "dptp")
    assert (stage, mp, cfg.model.shard_joint, cfg.model.compute_dtype) == \
        ("none", 2, True, "bfloat16")
    with pytest.raises(ValueError):
        scaling_predict.layout_config(cfg, "fsdp")
