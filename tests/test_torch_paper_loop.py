"""The paper's loop in the port against the JAX package, at
`benchmarks/fig10_robustness.py`'s size: train, write-and-verify, eval
loss digitally and through the arrays.

The reference trains the tiny LM for 20 steps (the two packages' own
training trajectories drift apart over many steps, so the params are
carried across); both then deploy them with the same key, by
`deploy_params` and by `deploy_arrays` + `CIMExecutor`, at fig10's
severe verify-read noise (0.7 LSB, `default_config_for_array(32)`).
Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block; nothing here changes process-wide state beyond a fixture that
runs the module on two torch threads and restores the count.

Tolerances:
* rms cell error: rtol 1e-5 (the same cells programmed; P2's ulps);
* digital eval loss (`materialize()`, `deploy_params`) and ideal
  in-array loss (`CIMExecutor` with ideal converters), port against the
  reference and ideal against digital: 1e-4, `benchmarks/cim_inference.py`
  's equivalence contract (measured ~1e-6);
* noisy in-array loss (DAC 6 / ADC 10 bits, read noise 0.7 LSB): within
  1e-3 of the reference's, a tenth of fig10's 0.01 band.  The partial
  sums are taken in another order and the reference's noise is up to 3
  ulp off, so a few ADC codes flip (measured ~1e-4).

`examples/torch_deploy_rram.py --device cpu --steps 3` runs to its table
in a subprocess.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.cim import CIMConfig as JCIMConfig
from repro.cim import CIMExecutor as JCIMExecutor
from repro.core import NoiseConfig as JNoiseConfig
from repro.core import WVMethod as JWVMethod
from repro.core import default_config_for_array as j_default_config
from repro.core.programmer import deploy_arrays as j_deploy_arrays
from repro.core.programmer import deploy_params as j_deploy_params
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.transformer import loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.convert import params_from_numpy
from repro_torch.core import NoiseConfig, WVMethod, default_config_for_array, rng
from repro_torch.core.programmer import deploy_arrays, deploy_params
from repro_torch.data import SyntheticLM
from repro_torch.models.transformer import loss_fn

from test_torch_train import DATA, LR_PEAK, _two_torch_threads, tiny_cfgs  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIGMA = 0.7          # fig10's severe verify-read noise, LSB
EVAL_STEP = 10_000   # fig10's eval batch
IDEAL = dict(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)
NOISY = dict(dac_bits=6, adc_bits=10, sigma_read_lsb=0.7)


def _legacy():
    return jax.threefry_partitionable(False)


@pytest.fixture(scope="module")
def trained():
    """The reference's tiny LM after 20 steps, its eval batch and loss,
    and the port's copies of both."""
    jcfg, tcfg = tiny_cfgs()
    with _legacy():
        opt = JAdamWConfig(lr_peak=LR_PEAK)
        st = j_init_train_state(jax.random.PRNGKey(0), jcfg, opt)
        step = jax.jit(j_make_train_step(jcfg, opt, total_steps=20))
        data = JSyntheticLM(**DATA)
        for i in range(20):
            st, _ = step(st, data.global_batch_at(i)._asdict())
        jbatch = data.global_batch_at(EVAL_STEP)._asdict()
    np_params = jax.tree.map(np.asarray, st.params)
    tbatch = SyntheticLM(**DATA, device="cpu").global_batch_at(EVAL_STEP)._asdict()
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=st.params, jbatch=jbatch,
                tparams=params_from_numpy(np_params, device="cpu"), tbatch=tbatch)


def _j_loss(t, params) -> float:
    with _legacy():
        return float(jax.jit(lambda p, b: j_loss_fn(p, b, t["jcfg"])[0])(params, t["jbatch"]))


def _t_loss(t, params) -> float:
    with torch.no_grad():
        return float(loss_fn(params, t["tbatch"], t["tcfg"])[0])


def _wv(method: str, port: bool):
    if port:
        return default_config_for_array(32).replace(
            method=WVMethod(method), noise=NoiseConfig(sigma_read_lsb=SIGMA))
    return j_default_config(32).replace(
        method=JWVMethod(method), noise=JNoiseConfig(sigma_read_lsb=SIGMA))


def test_trained_params_carry_the_eval_loss(trained):
    want = _j_loss(trained, trained["jparams"])
    assert abs(_t_loss(trained, trained["tparams"]) - want) <= 1e-5
    assert want < np.log(64)  # 20 steps learned something


@pytest.mark.parametrize("method", ["harp", "cw_sc"])
def test_deploy_params_digital_loss_matches(trained, method):
    with _legacy():
        jprog, jrep = j_deploy_params(jax.random.PRNGKey(42), trained["jparams"],
                                      _wv(method, False))
    prog, rep = deploy_params(rng.PRNGKey(42, device="cpu"), trained["tparams"],
                              _wv(method, True), device="cpu")
    np.testing.assert_allclose(rep.rms_cell_error_lsb, jrep.rms_cell_error_lsb, rtol=1e-5)
    assert abs(_t_loss(trained, prog) - _j_loss(trained, jprog)) <= 1e-4


@pytest.mark.parametrize("method", ["harp", "cw_sc"])
def test_deploy_arrays_in_array_losses_match(trained, method):
    with _legacy():
        jdep, jrep = j_deploy_arrays(jax.random.PRNGKey(42), trained["jparams"],
                                     _wv(method, False))
        j_losses = {
            "digital": _j_loss(trained, jdep.materialize()),
            "ideal": _j_loss(trained, JCIMExecutor(jdep, JCIMConfig(**IDEAL),
                                                   jax.random.PRNGKey(7)).params()),
            "noisy": _j_loss(trained, JCIMExecutor(jdep, JCIMConfig(**NOISY),
                                                   jax.random.PRNGKey(7)).params()),
        }
    dep, rep = deploy_arrays(rng.PRNGKey(42, device="cpu"), trained["tparams"],
                             _wv(method, True), device="cpu")
    key = rng.PRNGKey(7, device="cpu")
    losses = {
        "digital": _t_loss(trained, dep.materialize()),
        "ideal": _t_loss(trained, CIMExecutor(dep, CIMConfig(**IDEAL), key).params()),
        "noisy": _t_loss(trained, CIMExecutor(dep, CIMConfig(**NOISY), key).params()),
    }
    np.testing.assert_allclose(rep.rms_cell_error_lsb, jrep.rms_cell_error_lsb, rtol=1e-5)
    assert abs(losses["ideal"] - losses["digital"]) <= 1e-4, losses
    for k, tol in (("digital", 1e-4), ("ideal", 1e-4), ("noisy", 1e-3)):
        assert abs(losses[k] - j_losses[k]) <= tol, (k, losses[k], j_losses[k])
    assert all(np.isfinite(v) for v in losses.values())


def test_example_deploy_rram_runs_on_cpu():
    # Two threads, as in this module (see `_two_torch_threads`); this
    # process's own environment is left as it is.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_deploy_rram.py"),
         "--device", "cpu", "--steps", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("trained 3 steps on cpu; clean eval loss = ")
    rows = {ln.split()[0]: ln.split() for ln in lines
            if ln.split() and ln.split()[0] in ("cw_sc", "mra", "hd_pv", "harp")}
    assert set(rows) == {"cw_sc", "mra", "hd_pv", "harp"}
    for cols in rows.values():
        assert all(np.isfinite(float(c)) for c in cols[1:])
