"""The port's package namespaces carry the JAX package's public names: a
script written against `flashattention_kernel_project_tpu`'s `ops`,
`models`, `utils` and `parallel` runs against the port when only the import changes,
apart from the names listed here, each with the item that ports it."""

import importlib
import inspect

import pytest

# JAX functions whose port is a module of the same name, kept so that the
# launch counters stay one attribute away (ops.flash_attention._fwd, ...);
# the function is the module's attribute of the same name
MODULE_SHADOWS = {"ops": ["flash_attention", "flash_decode", "softmax"]}
# the TPU's own: the port has utils.platform's H100 peaks, require_hopper
# and card_label instead (a kept deviation, ROADMAP C)
TPU_ONLY = ["default_interpret", "has_tpu", "tpu_peak_flops", "tpu_hbm_bandwidth"]
ABSENT = {"": [], "ops": [], "models": [],
          "utils": TPU_ONLY,
          "parallel": []}


def _public(module):
    return sorted(n for n in dir(module) if not n.startswith("_"))


@pytest.mark.parametrize("sub", ["", "ops", "models", "utils", "parallel"])
def test_port_namespace_carries_jax_names(sub):
    suffix = f".{sub}" if sub else ""
    jax_ns = importlib.import_module("flashattention_kernel_project_tpu" + suffix)
    port = importlib.import_module("flashattention_kernel_project_tpu_torch" + suffix)
    shadows = MODULE_SHADOWS.get(sub, [])
    missing = [n for n in _public(jax_ns)
               if n not in ABSENT[sub] and not hasattr(port, n)]
    assert missing == [], f"{port.__name__} lacks {missing}"
    # a JAX function is a function (or class) in the port, not a module,
    # except for the kept module shadows
    kinds = [n for n in _public(jax_ns)
             if hasattr(port, n) and n not in shadows
             and inspect.ismodule(getattr(port, n))
             != inspect.ismodule(getattr(jax_ns, n))]
    assert kinds == [], f"{port.__name__}: modules where JAX has functions: {kinds}"
    for n in shadows:
        assert inspect.ismodule(getattr(port, n))
        assert callable(getattr(getattr(port, n), n))


@pytest.mark.parametrize("sub", ["", "models", "utils", "parallel"])
def test_absent_names_are_still_absent(sub):
    """The listed names are absent because their items are not ported; when
    one lands, it leaves its list."""
    suffix = f".{sub}" if sub else ""
    port = importlib.import_module("flashattention_kernel_project_tpu_torch" + suffix)
    assert [n for n in ABSENT[sub] if hasattr(port, n)] == []


def test_ops_reexports_are_the_modules_functions():
    from flashattention_kernel_project_tpu_torch import ops
    from flashattention_kernel_project_tpu_torch.ops import paged_decode, quant

    assert ops.paged_flash_decode is paged_decode.paged_flash_decode
    assert ops.quantize_kv is quant.quantize_kv
    assert ops.flash_decode_fp8 is ops.flash_decode.flash_decode_fp8
    assert ops.probes.copy_probe.launches == 0
