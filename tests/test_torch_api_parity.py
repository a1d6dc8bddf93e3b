"""The port's public surface against the JAX package's, module by module.

For every module of ``pytorchhessianfree_tpu`` (``parallel/`` included),
the port's module of the same name must define each public function and
class of the JAX module, with the same parameters (``inspect.signature``;
classes: their constructor and every public method).  The allow-lists hold
the recorded deviations and nothing else, and every entry must still be
needed, so that they shrink as the port grows:

- ``key`` -> ``generator`` (``torch.Generator`` in place of a PRNG key),
  and an added ``device`` where the port puts tensors on a device;
- ``fused_trials`` / ``FusedTrialsResult`` (``ops/select.py``) and
  ``lowrank_arg`` (``ops/nystrom.py``): eager PyTorch needs neither;
- the flax/haiku adapters, whose place the ``nn.Module`` adapter takes;
- ``initialize_distributed(backend=, device=)`` and the ``reduction=`` of
  ``make_dp_hf_step`` / ``make_dp_hf_train_loop`` and of
  ``make_sharded_hf_step`` / ``make_sharded_hf_train_loop``, added by the
  port.

No module of the JAX package is missing from the port.
"""

import importlib
import inspect
import pkgutil

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402

J, T = "pytorchhessianfree_tpu", "pytorchhessianfree_tpu_torch"

MISSING_MODULES = set()
MISSING_NAMES = {
    "ops.select": {"fused_trials", "FusedTrialsResult"},
    "ops.nystrom": {"lowrank_arg"},
    "interop": {"split_flax_variables", "flax_fns", "haiku_fns",
                "flax_state_update", "haiku_state_update"},
}
MISSING_PARAMS = {}
ADDED_PARAMS = {
    ("parallel.distributed", "initialize_distributed"): {"backend"},
    ("parallel.data_parallel", "make_dp_hf_step"): {"reduction"},
    ("parallel.data_parallel", "make_dp_hf_train_loop"): {"reduction"},
    ("parallel.sharded", "make_sharded_hf_step"): {"reduction"},
    ("parallel.sharded", "make_sharded_hf_train_loop"): {"reduction"},
}
RENAMED = {"key": "generator"}
ADDED_ANYWHERE = {"device"}

JAX_MODULES = sorted(
    m.name[len(J) + 1:]
    for m in pkgutil.walk_packages(jhf.__path__, J + ".")
)


def public(module):
    """Functions and classes that ``module`` itself defines."""
    return {
        name: obj for name, obj in vars(module).items()
        if not name.startswith("_")
        and (inspect.isfunction(obj) or inspect.isclass(obj))
        and obj.__module__ == module.__name__
    }


def params(obj):
    return [p for p in inspect.signature(obj).parameters]


def methods(cls):
    """Public methods and properties a class defines itself."""
    return {
        name: obj for name, obj in vars(cls).items()
        if not name.startswith("_")
        and (inspect.isfunction(obj) or isinstance(obj, property))
    }


def signature_gaps(where, j_obj, t_obj, used):
    """Parameters of ``j_obj`` that ``t_obj`` lacks and ones it adds,
    minus the allowed ones (recorded in ``used``)."""
    jp = [RENAMED.get(p, p) for p in params(j_obj)]
    tp = params(t_obj)
    missing = set(jp) - set(tp)
    added = set(tp) - set(jp) - ADDED_ANYWHERE
    allowed_missing = MISSING_PARAMS.get(where, set())
    allowed_added = ADDED_PARAMS.get(where, set())
    used.update((where, "-", p) for p in missing & allowed_missing)
    used.update((where, "+", p) for p in added & allowed_added)
    return missing - allowed_missing, added - allowed_added


@pytest.mark.parametrize("name", JAX_MODULES)
def test_port_module_has_the_jax_surface(name):
    if name in MISSING_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(f"{T}.{name}")
        return
    jmod = importlib.import_module(f"{J}.{name}")
    tmod = importlib.import_module(f"{T}.{name}")
    jpub, tpub = public(jmod), public(tmod)
    allowed = MISSING_NAMES.get(name, set())
    missing = set(jpub) - set(vars(tmod)) - allowed
    assert not missing, f"{name} lacks {sorted(missing)}"
    assert allowed <= set(jpub) - set(vars(tmod)), \
        f"stale allow-list entries {sorted(allowed & set(vars(tmod)))}"

    used, gaps = set(), {}
    for obj_name in sorted(set(jpub) - allowed):
        j_obj, t_obj = jpub[obj_name], getattr(tmod, obj_name)
        pairs = [(obj_name, j_obj, t_obj)]
        if inspect.isclass(j_obj):
            for m, j_m in methods(j_obj).items():
                assert hasattr(t_obj, m), f"{name}.{obj_name}.{m} missing"
                t_m = inspect.getattr_static(t_obj, m)
                if not isinstance(j_m, property):
                    pairs.append((f"{obj_name}.{m}", j_m, t_m))
        for label, j_o, t_o in pairs:
            lacks, adds = signature_gaps((name, label), j_o, t_o, used)
            if lacks or adds:
                gaps[label] = (sorted(lacks), sorted(adds))
    assert not gaps, f"{name}: (lacks, adds) {gaps}"
    expected = {(w, "-", p) for w, ps in MISSING_PARAMS.items() for p in ps
                if w[0] == name}
    expected |= {(w, "+", p) for w, ps in ADDED_PARAMS.items() for p in ps
                 if w[0] == name}
    assert used == expected, f"stale entries {sorted(expected - used)}"


def test_every_jax_module_is_compared():
    assert {"parallel.distributed", "parallel.mesh",
            "parallel.data_parallel", "optimizer", "ops.cg"} \
        <= set(JAX_MODULES)
    assert MISSING_MODULES <= set(JAX_MODULES)
    assert set(MISSING_NAMES) | {w[0] for w in MISSING_PARAMS} \
        | {w[0] for w in ADDED_PARAMS} <= set(JAX_MODULES)
