"""repro_torch.configs against repro.configs: every field of the ten
architectures and of their smoke configs, the shapes, the applicability
matrix, the input specs and the parameter counts."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.models import build_model

ARCHS = sorted(jconfigs.all_configs())
DECODERS = [a for a in ARCHS if jconfigs.all_configs()[a].family not in ("ssm", "audio")]


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    dtype = out.pop("dtype")
    out["dtype"] = str(dtype).rsplit(".", 1)[-1] if isinstance(dtype, torch.dtype) \
        else jnp.dtype(dtype).name
    return out


def test_the_same_ten_architectures():
    assert sorted(tconfigs.all_configs()) == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch):
    ref, port = jconfigs.all_configs()[arch], tconfigs.all_configs()[arch]
    assert _fields(port) == _fields(ref)
    assert port.dtype is torch.bfloat16
    assert (port.resolved_head_dim, port.sub_quadratic) == (ref.resolved_head_dim, ref.sub_quadratic)
    assert tconfigs.get_config(arch) is port


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_fields_match(arch):
    ref = jconfigs.smoke_config(jconfigs.all_configs()[arch])
    port = tconfigs.smoke_config(tconfigs.all_configs()[arch])
    assert _fields(port) == _fields(ref)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


def test_shapes_and_applicability_match():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ARCHS:
        for name in jconfigs.SHAPES:
            assert tconfigs.shape_applicable(tconfigs.all_configs()[arch], tconfigs.SHAPES[name]) \
                == jconfigs.shape_applicable(jconfigs.all_configs()[arch], jconfigs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match(arch):
    for name in jconfigs.SHAPES:
        ref = jconfigs.input_specs(jconfigs.all_configs()[arch], jconfigs.SHAPES[name])
        port = tconfigs.input_specs(tconfigs.all_configs()[arch], tconfigs.SHAPES[name])
        assert sorted(port) == sorted(ref)
        for key, spec in port.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(ref[key].shape)
            assert str(spec.dtype).rsplit(".", 1)[-1] == jnp.dtype(ref[key].dtype).name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches(arch):
    ref, port = jconfigs.all_configs()[arch], tconfigs.all_configs()[arch]
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", DECODERS)
def test_meta_model_holds_param_count(arch):
    cfg = tconfigs.all_configs()[arch]
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert all(p.device.type == "meta" for p in model.parameters())
    abstract = model.abstract()
    assert abstract["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert model.logical()["embed"] == ("vocab", "embed")


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny"])
def test_unported_families_raise(arch):
    """The two families that raised NotImplementedError until their port
    (ROADMAP.md queue 1, item 5) build now, at their full declared size."""
    model = build_model(tconfigs.all_configs()[arch], device="meta")
    assert type(model).__name__ == {"xlstm-350m": "XLSTMModel", "whisper-tiny": "EncDecModel"}[arch]
    assert sum(p.numel() for p in model.parameters()) == model.cfg.param_count()


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers the default")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(tconfigs.smoke_config(tconfigs.get_config("granite-3-2b")))
