"""The plain reference against the program at tiny sizes, and the
correctness check seeing the control and each fault a served cell can
have (CPU, float32, the harness's look for the card skipped)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH / "tests"))
sys.path.insert(1, str(BENCH.parent))

import h100bench_tiny as tiny  # noqa: E402
import run  # noqa: E402
from harness import judge, weights  # noqa: E402
from harness.serve import photo  # noqa: E402
from harness.tokenizer import WordTokenizer, prompt_ids  # noqa: E402
from reference import vlm as ref  # noqa: E402

SEED = 2**32 + 977
ALL = {"min_tokens": 10**6, "max_requests": 10**6}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_matches_the_program_logits(moe):
    from lumen_tpu_torch.models.vlm import VLMConfig, VLMModel

    cfg = tiny.tiny_config(moe)
    state = weights.make(cfg, SEED, "cpu", torch.float32)
    with torch.device("meta"):
        model = VLMModel(VLMConfig.from_hf(cfg))
    model.load_state_dict(state, strict=True, assign=True)
    model.eval()
    shape = ref.shape_of(cfg)
    pixels = torch.from_numpy(photo(5, shape.image_size))
    ids = prompt_ids(WordTokenizer(shape.vocab), "a small red car", shape.image_token_id) + [1234, 2345]
    with torch.no_grad():
        x = (pixels.float() / 255.0)[None]
        got = model(torch.tensor([ids]), x)[0]
    w = ref.Weights(state, "cpu")
    inputs, _ = ref.caption_inputs(w, shape, pixels, ids, [])
    want = ref.decoder_logits(w, shape, [inputs], [list(range(inputs.shape[0]))])[0]
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 2e-4 * want.abs().max().item()


def _run(tmp_path, **kw):
    bench = tiny.make_bench(tmp_path, moe=kw.pop("moe", False), limits={"gap_max": 1e-3, "gap_mean": 1e-4})
    rules = bench.cell("tiny-cell")
    rules["sample"] = ALL
    (bench.folder / "cells" / "tiny-cell.json").write_text(json.dumps(rules))
    return run.run_once(bench, "tiny-cell", SEED, 2.5, False, device="cpu", **kw)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_a_sound_run_is_correct(tmp_path, moe):
    r = _run(tmp_path, moe=moe)
    assert r["correct"], r["checks"]
    assert r["_found"]["tokens"] >= 40 and r["failed"] == 0
    assert set(r["metrics"]) == {"tok_s", "setup_s"}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_the_float8_reference_control_is_not_correct(tmp_path, moe):
    """The control: the reference in float8 put in the program's place,
    read on the same requests as a sound run and judged by the cell's
    limits, as ``control.py`` judges it."""
    r = _run(tmp_path, moe=moe, control=True)
    assert r["correct"]
    limits = json.loads((tmp_path / "benchmark" / "cells" / "tiny-cell.json").read_text())["limits"]
    ok, checks = judge.verdict(r["_control"], limits)
    assert not ok, checks


def test_the_verdict_fails_readings_above_a_limit(tmp_path):
    limits = tiny.make_bench(tmp_path).cell("tiny-cell")["limits"]
    within = {name: 0.5 * limit for name, limit in limits.items()}
    assert judge.verdict(within, limits)[0]
    for name, limit in limits.items():
        ok, checks = judge.verdict(dict(within, **{name: 2 * limit}), limits)
        assert not ok and checks[name] == {"value": 2 * limit, "limit": limit}
    # a reading missing, a limit not set: not correct
    assert not judge.verdict({}, limits)[0]
    assert not judge.verdict(within, dict(limits, gap_max=None))[0]


def _fault_unchanged_state(monkeypatch):
    from lumen_tpu_torch.models.vlm import generate

    orig = generate.Generator.step_block

    def step_block(self, pool, *a, **k):
        tok, ln = pool["cur_tok"].clone(), pool["cur_len"].clone()
        out = orig(self, pool, *a, **k)
        pool["cur_tok"], pool["cur_len"] = tok, ln
        return out

    monkeypatch.setattr(generate.Generator, "step_block", step_block)


def _fault_half_batch(monkeypatch):
    from lumen_tpu_torch.models.vlm import modeling

    orig = modeling.VLMModel.decode_paged

    def decode_paged(self, *a, **k):
        logits, caches = orig(self, *a, **k)
        logits = logits.clone()
        # the odd rows left out: each takes the even row's logits before it
        logits[1::2] = logits[0:-1:2]
        return logits, caches

    monkeypatch.setattr(modeling.VLMModel, "decode_paged", decode_paged)


def _fault_altered_token(monkeypatch):
    from lumen_tpu_torch.models.vlm import generate

    orig = generate.Generator.step_block
    calls = {"n": 0}

    def step_block(self, *a, **k):
        out = orig(self, *a, **k)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            out = out.clone()
            out[:, -1] = (out[:, -1] + 1) % self.cfg.decoder.vocab_size
        return out

    monkeypatch.setattr(generate.Generator, "step_block", step_block)


@pytest.mark.parametrize("fault", [_fault_unchanged_state, _fault_half_batch, _fault_altered_token],
                         ids=["unchanged-state", "half-batch", "altered-token"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tmp_path)
    assert not r["correct"], r["checks"]
