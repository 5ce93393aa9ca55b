"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, once for each fault that a cell can have (one card: no
exchange between chips to leave out). And the control, the reference in
the next lower precision in the program's place, fails a limit that the
program passes."""

import pytest
import torch

from benchmark.tests.tiny import run_cpu


def test_state_left_unchanged(in_tree, monkeypatch):
    from tpuasr_torch.train.optim import GuardedAdam

    monkeypatch.setattr(GuardedAdam, "update_guarded",
                        lambda self, grads, state, params, finite, *a, **k: state)
    r = run_cpu("tiny_rnnt.train.b4")
    assert r["correct"] is False
    assert r["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(in_tree, monkeypatch):
    import tpuasr_torch.train as train

    make = train.make_train_step

    def half(*a, **k):
        step = make(*a, **k)
        return lambda state, batch, seed: step(
            state, {n: v[:v.shape[0] // 2] for n, v in batch.items()}, seed)

    monkeypatch.setattr(train, "make_train_step", half)
    r = run_cpu("tiny_rnnt.train.b4")
    assert r["correct"] is False
    assert r["checks"]["loss"]["value"] > r["checks"]["loss"]["limit"]


def test_half_the_batch_left_out_of_the_aed_cell(in_tree, monkeypatch):
    """The hybrid CTC / attention cell (SpecAugment on) catches the same fault."""
    from benchmark.tools import readings

    with readings.half_batch():
        r = run_cpu("tiny_u2pp.train.b4")
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_references_own_greedy_reads_no_gap(in_tree):
    """The fp32 reference in the program's place, serving its own greedy
    tokens through the comparison, reads 0: the search and the comparison
    agree on what greedy decides."""
    from benchmark.tools import readings

    c, _ = readings.cell_of("tiny_rnnt.stream.s6", 2**31 + 5, torch.device("cpu"))
    c.setup()
    c.release()
    r = c.readings(controls=("fp32", "tf32"))
    assert r["gap"] == 0.0 and r["ctl"][0] == 0.0


def test_a_token_altered_where_it_is_produced(in_tree, monkeypatch):
    import tpuasr_torch.decode as decode

    chunk = decode.process_chunk

    def altered(model, feats, state, *a, **k):
        state = chunk(model, feats, state, *a, **k)
        hyp, n = state.dec.hyp, state.dec.hyp_len
        rows = torch.nonzero(n > 0)[:, 0]
        last = hyp[rows, n[rows] - 1]
        v = model.cfg.vocab_size
        hyp[rows, n[rows] - 1] = 6 + (last - 6 + 1) % (v - 6)  # another content token
        return state

    monkeypatch.setattr(decode, "process_chunk", altered)
    r = run_cpu("tiny_rnnt.stream.s6")
    assert r["correct"] is False
    assert r["checks"]["gap"]["value"] > r["checks"]["gap"]["limit"]


def test_training_control_fails_a_limit(in_tree):
    """fp8 operands in the reference (the configuration trains in bf16)
    read above one of the tiny cell's limits; the program reads below all."""
    from benchmark.tools import readings

    out = readings.train_readings("tiny_rnnt.train.b4", 2**31 + 3, torch.device("cpu"))
    from benchmark.tests.tiny import TINY_TRAIN

    lim = TINY_TRAIN["limits"]
    assert all(out["program"][k] <= lim[k] for k in lim)
    assert any(out["control"][k] > lim[k] for k in lim)
    assert any(out["half_batch"][k] > lim[k] for k in lim)
