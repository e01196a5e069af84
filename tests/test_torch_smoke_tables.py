"""``chip_smoke.py``'s one draw of an embeds frontend's two tables: the
train steps' table (``data.pipeline.embed_table`` of data seed 0) and the
served demo table (``serve.engine.sample_table``) come bit for bit from a
single pass over RandomState(0)'s normal stream, in chunks of rows, and
``embeds_table`` hands each out once from a prefetched draw."""

import concurrent.futures
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, embed_table
from repro_torch.serve.engine import sample_table


@pytest.fixture(scope="module")
def smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(name, vocab, d):
    return dataclasses.replace(get_config(name), vocab_size=vocab, d_model=d)


@pytest.mark.parametrize("name,vocab,d,rows", [
    ("qwen2-vl-72b", 300, 16, 64),      # chunks of 64 rows, a ragged last one
    ("qwen2-vl-72b", 300, 16, 4096),    # one chunk
    ("musicgen-large", 130, 24, 7),     # an odd chunk: the stream's pairs
])
def test_one_draw_gives_both_tables(smoke, monkeypatch, name, vocab, d, rows):
    monkeypatch.setattr(smoke, "TABLE_ROWS", rows)
    cfg = _small(name, vocab, d)
    got = smoke.draw_embeds_tables(cfg)
    want_train = embed_table(DataConfig(vocab_size=vocab, seq_len=8,
                                        global_batch=2, seed=0), d)
    assert got["train"].dtype == want_train.dtype
    assert np.array_equal(got["train"], want_train)
    want_serve = sample_table(cfg, device="cpu")
    assert got["serve"].dtype == want_serve.dtype == cfg.dtype()
    assert torch.equal(got["serve"], want_serve)


def test_a_prefetched_draw_is_handed_out_once_per_kind(smoke, monkeypatch):
    cfg = _small("qwen2-vl-72b", 40, 8)
    monkeypatch.setattr(smoke, "_TABLES", {})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        smoke._TABLES[cfg.name] = pool.submit(smoke.draw_embeds_tables, cfg)
        train = smoke.embeds_table(cfg, "train")
        assert cfg.name in smoke._TABLES
        serve = smoke.embeds_table(cfg, "serve")
    assert cfg.name not in smoke._TABLES
    fresh = smoke.draw_embeds_tables(cfg)
    assert np.array_equal(train, fresh["train"])
    assert torch.equal(serve, fresh["serve"])
    # Without a prefetched draw the table is drawn on the spot.
    assert torch.equal(smoke.embeds_table(cfg, "serve"), fresh["serve"])
