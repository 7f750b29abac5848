"""The port's copy of the config registry against the JAX package's: every
registered name, its fields, `reduced()`, the derived counts and patterns;
and the port's parameter trees against the reference's element counts."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES, get_config as ref_get_config, list_configs as ref_list_configs
from repro.models import transformer as RT
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.models import transformer as T

ARCHS = list_configs()


def test_registry_names():
    assert ARCHS == ref_list_configs() and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    mine, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    for c, r in ((mine, ref), (mine.reduced(), ref.reduced())):
        assert (c.hd, c.vocab_padded, c.period) == (r.hd, r.vocab_padded, r.period)
        assert c.layer_kinds() == r.layer_kinds() and c.pattern_kinds() == r.pattern_kinds()
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_params_have_the_reference_element_count(arch):
    cfg = get_config(arch).reduced()
    ref = RT.abstract_params(ref_get_config(arch).reduced())
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref))
    params = T.init_params(cfg, device="cpu")
    assert sum(p.numel() for p in params.parameters()) == want
    meta = T.abstract_params(cfg)
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert sum(p.numel() for p in meta.parameters()) == want


def test_param_count_analytic_vs_actual():
    """tests/test_models.py:105 for the port: param_count within 2% of the
    real tree for a dense arch."""
    small = get_config("qwen3-0.6b").reduced()
    actual = sum(p.numel() for p in T.init_params(small, device="cpu").parameters())
    assert abs(actual - small.param_count()) / actual < 0.02


def test_full_configs_on_meta():
    """The full-size trees, shapes only: the published layer counts and the
    parameter totals the analytic counts approximate."""
    for arch in ARCHS:
        cfg = get_config(arch)
        params = T.abstract_params(cfg)
        assert len(params["blocks"]) == cfg.n_layers
        total = sum(p.numel() for p in params.parameters())
        assert 0.7 < total / cfg.param_count() < 1.3, (arch, total, cfg.param_count())
