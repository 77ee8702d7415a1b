"""The solver backend names of the port's ``mpc.solve``.

``'riccati_pallas_interpret'`` is the reference's fused Riccati kernel run by
the Pallas interpreter (``hector/mpc.py:165-190``).  The port runs the fused
solver's plain PyTorch version under that name, on any device, with no
kernel launch: on CPU tensors that is what ``'riccati_pallas'`` runs too.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import runtime as JRT
from hector.config import DEFAULT_CONFIG as JCFG

from hector_torch import cuda
from hector_torch import mpc as TM
from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.qp import fused_riccati as FR

from .test_torch_slice import (_jax_batch, _port_mpc_args, _to_port,
                               _with_solver)

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

# float32, port vs the reference's interpreted Pallas kernel on one planning
# step: the bar chip_smoke.py holds the card's step to against the CPU (the
# two sides build the QP in float32 in another order, and the fixed-sigma
# interior point carries that to the forces)
STEP_TOL_F32 = 1e-2


def _port_state(batch, dtype, seed):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    return _to_port(*_jax_batch(batch, jdtype, seed), dtype)


@pytest.mark.parametrize('polish_rounds', [0, 8], ids=['ip', 'polish'])
def test_riccati_pallas_interpret_is_the_plain_fused_solver(polish_rounds):
    """On CPU tensors 'riccati_pallas_interpret' and 'riccati_pallas' give
    the same QPSolution bit for bit, and neither launches a kernel."""
    args = _port_mpc_args(*_port_state(4, torch.float32, seed=7))
    sols = []
    for backend in ('riccati_pallas', 'riccati_pallas_interpret'):
        cfg = _with_solver(TCFG, backend=backend, polish_rounds=polish_rounds)
        _, parts = TM.build_parts(*args, cfg)
        before = cuda.counts.read()
        sols.append(TM.solve(parts, cfg))
        assert cuda.counts.read() == before
    assert float(sols[0].u.abs().max()) > 10.0
    for name in sols[0]._fields:
        assert torch.equal(getattr(sols[0], name), getattr(sols[1], name)), name


def test_plan_step_fn_accepts_riccati_pallas_interpret():
    carry, plant, cmd = _port_state(4, torch.float64, seed=8)
    outs = [TRT.plan_step_fn(_with_solver(TCFG, backend=b))(carry, plant, cmd)
            for b in ('riccati_pallas', 'riccati_pallas_interpret')]
    assert float(outs[0][1].abs().max()) > 10.0
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2].tau, outs[1][2].tau)
    assert torch.equal(outs[0][0].planner.f_ff, outs[1][0].planner.f_ff)


def test_backend_names_that_are_not_ported_or_unknown_raise(monkeypatch):
    """The fused solver's horizon check holds under the interpret name too;
    'qpoases' without the qpOASES sources says that they are missing (it
    never plans in their place); an unknown name is refused as such."""
    from hector_torch.qp import ref_check
    monkeypatch.setattr(ref_check, 'QPOASES_REF_DIR', '/nonexistent/qpOASES')
    carry, plant, cmd = _port_state(2, torch.float64, seed=3)
    cfg = _with_solver(TCFG, backend='riccati_pallas_interpret')
    cfg = dataclasses.replace(cfg, mpc=dataclasses.replace(TCFG.mpc,
                                                           horizon=8))
    with pytest.raises(ValueError, match='horizon'):
        TRT.plan_step_fn(cfg)(carry, plant, cmd)
    with pytest.raises(RuntimeError, match='qpOASES sources'):
        TRT.plan_step_fn(_with_solver(TCFG, backend='qpoases'))(
            carry, plant, cmd)
    with pytest.raises(ValueError, match='unknown solver backend'):
        TRT.plan_step_fn(_with_solver(TCFG, backend='riccati_palas'))(
            carry, plant, cmd)


@pytest.mark.slow
def test_plan_step_matches_jax_riccati_pallas_interpret():
    """Against the reference's plan step under the same name, which runs the
    fused Pallas kernel in interpret mode (traces for minutes on a CPU,
    hence slow)."""
    carry, plant, cmd = _jax_batch(4, jnp.float32, seed=9)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, torch.float32)
    name = 'riccati_pallas_interpret'
    j_step = jax.jit(jax.vmap(JRT.plan_step_fn(_with_solver(JCFG,
                                                            backend=name))))
    _, j_wrench, j_motor = j_step(carry, plant, cmd)
    _, t_wrench, t_motor = TRT.plan_step_fn(_with_solver(TCFG, backend=name))(
        t_carry, t_plant, t_cmd)
    assert float(np.abs(np.asarray(j_wrench)).max()) > 10.0
    np.testing.assert_allclose(t_wrench.numpy(), np.asarray(j_wrench),
                               atol=STEP_TOL_F32, rtol=0)
    np.testing.assert_allclose(t_motor.tau.numpy(), np.asarray(j_motor.tau),
                               atol=STEP_TOL_F32, rtol=0)
