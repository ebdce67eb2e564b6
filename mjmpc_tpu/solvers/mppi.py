"""Model Predictive Path Integral control (Williams et al. 2017).

Math matches reference mjmpc/control/mppi.py:69-131 exactly: exponential-
utility weights over discounted cost-to-go plus optional control cost,
step-size-blended mean update, free-energy value estimate. All reductions
are over the particle axis, which shards across the device mesh — the
softmax/sum lower to psum collectives under pjit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import ops
from ..rollout.engine import Trajectories
from .base import GaussianMPC, GaussianState


@dataclasses.dataclass(frozen=True)
class MPPI(GaussianMPC):
    lam: float = 1.0
    alpha: int = 0                    # 0: control cost on; 1: off (mppi.py:66)
    time_based_weights: bool = False

    def _control_costs(self, state: GaussianState, delta: jax.Array) -> jax.Array:
        """0.5 * (mean Σ⁻¹) · (mean + 2 delta), summed over action dims and
        discounted (mppi.py:99-111)."""
        if self.alpha == 1:
            shape = ((delta.shape[0], delta.shape[1]) if self.time_based_weights
                     else (delta.shape[0],))
            return jnp.zeros(shape, delta.dtype)
        u_normalized = (state.mean @ jnp.linalg.inv(state.cov))[None, :, :]
        cc = 0.5 * u_normalized * (state.mean[None, :, :] + 2.0 * delta)
        cc = jnp.sum(cc, axis=-1)
        cc = ops.cost_to_go(cc, self.gamma_seq)
        if not self.time_based_weights:
            cc = cc[:, 0]
        return cc

    def _exp_util(self, state: GaussianState, costs, delta) -> jax.Array:
        """Softmax(-(ctg + lam*control_cost)/lam) (mppi.py:84-97)."""
        traj_costs = ops.cost_to_go(costs, self.gamma_seq)
        if not self.time_based_weights:
            traj_costs = traj_costs[:, 0]
        total = traj_costs + self.lam * self._control_costs(state, delta)
        return jax.nn.softmax((-1.0 / self.lam) * total, axis=0)

    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        """mppi.py:69-82."""
        delta = traj.actions - state.mean[None, :, :]
        w = self._exp_util(state, traj.costs, delta)
        # HIGHEST: a GPU runs a default-precision f32 contraction in TF32
        hi = jax.lax.Precision.HIGHEST
        if self.time_based_weights:
            weighted = jnp.einsum("nh,nhd->hd", w, traj.actions,
                                  precision=hi)
        else:
            weighted = jnp.einsum("n,nhd->hd", w, traj.actions,
                                  precision=hi)
        return state._replace(mean=self._interp_mean(state.mean, weighted))

    def value(self, state: GaussianState, traj: Trajectories) -> jax.Array:
        """Free energy -lam*logsumexp(-cost/lam)/N (mppi.py:113-131)."""
        delta = traj.actions - state.mean[None, :, :]
        traj_costs = ops.cost_to_go(traj.costs, self.gamma_seq)[:, 0]
        cc = self._control_costs(state, delta) if not self.time_based_weights \
            else self._control_costs(state, delta)[:, 0]
        total = traj_costs + self.lam * cc
        n = total.shape[0]
        return -self.lam * (jax.scipy.special.logsumexp(
            (-1.0 / self.lam) * total) - jnp.log(jnp.float32(n)))
