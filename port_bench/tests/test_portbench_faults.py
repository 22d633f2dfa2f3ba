"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of a tiny cell on the CPU (run.py's ``_measure``: set-up, window,
release, the comparison with the plain reference against the cell's
limits, the result line), with one fault planted in the program through
a wrapper of the call that produces the answer. The faults are those a
cell of its kind can have: an answer altered where it is produced, half
of the work left out; for the eval also one member's head wrong (the
member fold alone); for training also a step that returns its state
unchanged and a backward whose sign is wrong."""

import argparse
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from port_bench.harness import spec
from port_bench.tests.tiny import tiny_run


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench"))


def _result(name, cache):
    import port_bench.run as R

    run = tiny_run(name, cache)
    args = argparse.Namespace(seconds=0.5, trace=0)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = R._measure(run, args, spec, torch)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _wrap_fold(monkeypatch, alter, members=lambda m: m):
    import popcorn_tpu_torch.infer.sliding as sliding

    make = sliding.make_patch_forward

    def make_patch_forward(*a, **kw):
        fn = make(*a, **kw)
        seen = [0]

        def broken(member_params, batch):
            res = fn(members(member_params), batch)
            seen[0] += 1
            return alter(res, seen[0])

        broken.static_int8, broken.calibrate = fn.static_int8, fn.calibrate
        return broken

    monkeypatch.setattr(sliding, "make_patch_forward", make_patch_forward)


def test_sound_eval_is_correct(cache):
    assert _result("eval-bag5-sidecar", cache)["correct"] is True


def test_eval_answer_altered(cache, monkeypatch):
    def alter(res, i):
        if i % 7 == 3:  # one patch in seven: its density sums doubled
            res = dict(res, dense_sum=res["dense_sum"] * 2, dense_sq=res["dense_sq"] * 4)
        return res

    _wrap_fold(monkeypatch, alter)
    assert _result("eval-bag5-sidecar", cache)["correct"] is False


def test_eval_half_the_patches_left_out(cache, monkeypatch):
    def alter(res, i):
        return {k: v * 0 for k, v in res.items()} if i % 2 else res

    _wrap_fold(monkeypatch, alter)
    assert _result("eval-bag5-sidecar", cache)["correct"] is False


def test_eval_one_members_head_wrong(cache, monkeypatch):
    def members(member_params):
        """Member 0's first head layer with its input features reversed."""
        p0 = dict(member_params[0])
        head = dict(p0["head"])
        head["l1"] = dict(head["l1"], w=head["l1"]["w"].flip(0))
        p0["head"] = head
        return [p0] + list(member_params[1:])

    _wrap_fold(monkeypatch, lambda res, i: res, members)
    assert _result("eval-bag5-sidecar", cache)["correct"] is False


def _wrap_step(monkeypatch, broken_call):
    import popcorn_tpu_torch.train.trainer as trainer_mod

    make = trainer_mod.make_train_step

    def make_train_step(*a, **kw):
        step = make(*a, **kw)

        class Broken:
            def __getattr__(self, k):
                return getattr(step, k)

            def __call__(self, params, opt_state, batch, generator=None, **kw2):
                return broken_call(step, params, opt_state, batch, generator, **kw2)

        return Broken()

    monkeypatch.setattr(trainer_mod, "make_train_step", make_train_step)


def test_sound_training_is_correct(cache):
    assert _result("train-member-resident", cache)["correct"] is True


def test_training_state_unchanged(cache, monkeypatch):
    def call(step, params, opt_state, batch, generator, **kw):
        _, _, aux = step(params, opt_state, batch, generator, **kw)
        return params, opt_state, aux

    _wrap_step(monkeypatch, call)
    assert _result("train-member-resident", cache)["correct"] is False


def test_training_half_the_batch(cache, monkeypatch):
    def call(step, params, opt_state, batch, generator, **kw):
        n = batch["y"].shape[0]
        half = {k: (v[: max(1, n // 2)] if k != "photometric" and v.dim() else v)
                for k, v in batch.items()}
        new, opt, aux = step(params, opt_state, half, generator, **kw)
        # the left-out samples' counts repeat the kept ones, so the trainer's
        # logging still gets one count a sample
        aux["popcount"] = aux["popcount"].repeat(2)[:n]
        return new, opt, aux

    _wrap_step(monkeypatch, call)
    assert _result("train-member-resident", cache)["correct"] is False


def test_training_answer_altered(cache, monkeypatch):
    def call(step, params, opt_state, batch, generator, **kw):
        new, opt, aux = step(params, opt_state, batch, generator, **kw)
        new["head"]["l4"]["b"] = new["head"]["l4"]["b"] + 1e-3
        return new, opt, aux

    _wrap_step(monkeypatch, call)
    assert _result("train-member-resident", cache)["correct"] is False


def test_training_gradient_sign_flipped(cache, monkeypatch):
    """Every gradient times -1 where the optimizer gets it: Adam's step
    keeps its size, the parameters move the wrong way."""
    import popcorn_tpu_torch.train.state as state_mod

    update = state_mod.Optimizer.update

    def flipped(self, grads, opt_state, params):
        neg = state_mod.tree_unflatten((p, -g) for p, g in state_mod.tree_flatten(grads))
        return update(self, neg, opt_state, params)

    monkeypatch.setattr(state_mod.Optimizer, "update", flipped)
    assert _result("train-member-resident", cache)["correct"] is False
