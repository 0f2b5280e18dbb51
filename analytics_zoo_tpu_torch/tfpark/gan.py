"""GANEstimator: alternating two-optimizer adversarial training, the
port of ``analytics_zoo_tpu/tfpark/gan.py``.

The six losses are the reference's (``d_loss(real_logits,
fake_logits)``, ``g_loss(fake_logits)``; the minimax generator loss is
the non-saturating one).  :class:`GANEstimator` trains a torch generator
(noise ``[B, noise_dim]`` -> sample) against a torch discriminator
(sample -> logits) on one device.  Each step, in the reference's order:

1. ``d_steps`` discriminator updates, each on fresh noise, with the
   generator's samples detached;
2. one generator update against the discriminator as those updates left
   it, on fresh noise again.

The noise is ``N(0, 1)`` in f32 from a ``torch.Generator`` seeded with
``fold_in(fold_in(seed, step), i)`` (``i`` the draw within the step,
the generator's last), so one seed gives one history; it is not
threefry, so its samples are not the reference's (:meth:`_noise` is
the one place a draw is made).  The optimizers default to the
reference's ``optax.adam(2e-4, b1=0.5)``: ``torch.optim.Adam(lr=2e-4,
betas=(0.5, 0.999), eps=1e-8)``; ``generator_optimizer`` and
``discriminator_optimizer`` take a learning rate (Adam) or ``params ->
Optimizer``.  ``fit`` returns one entry an epoch: the mean over its
steps of ``d_loss`` (each step's last discriminator loss) and
``g_loss``, ``epoch`` and ``steps``.

``mesh=`` (default: the running context's, on the card) runs data
parallelism over the mesh's batch axes (``dp``), one process a rank, as
the reference shards its batch over them and replicates over the rest:
the ranks start from rank 0's weights, each takes its rows of every
global batch and of every noise draw (the global batch's draw, its rows
kept), the generator's and the discriminator's gradients are averaged
over dp before each optimizer steps, and the losses are means over dp,
so dp=N trains what dp=1 trains.  Ranks on another axis compute as the
rank of their dp coordinate does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.log import logger
from analytics_zoo_tpu_torch.data.loader import (DataCreator,
                                                 NumpyBatchIterator)
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.transformer import fold_in
from analytics_zoo_tpu_torch.parallel import data_parallel


def _bce(logits, target: float):
    return torch.mean(F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target), reduction="none"))


def minimax_d_loss(real, fake):
    return _bce(real, 1.0) + _bce(fake, 0.0)


def minimax_g_loss(fake):
    # non-saturating variant (the practical default)
    return _bce(fake, 1.0)


def lsgan_d_loss(real, fake):
    return 0.5 * (torch.mean((real - 1.0) ** 2) + torch.mean(fake ** 2))


def lsgan_g_loss(fake):
    return 0.5 * torch.mean((fake - 1.0) ** 2)


def wasserstein_d_loss(real, fake):
    return torch.mean(fake) - torch.mean(real)


def wasserstein_g_loss(fake):
    return -torch.mean(fake)


_LOSSES = {
    "minimax": (minimax_d_loss, minimax_g_loss),
    "lsgan": (lsgan_d_loss, lsgan_g_loss),
    "wasserstein": (wasserstein_d_loss, wasserstein_g_loss),
}


def _adam_gan(params):
    """``optax.adam(2e-4, b1=0.5)``: b2 0.999, eps 1e-8."""
    return torch.optim.Adam(params, lr=2e-4, betas=(0.5, 0.999), eps=1e-8)


def _optimizer(spec, params):
    if spec is None:
        return _adam_gan(params)
    if isinstance(spec, (int, float)):
        return torch.optim.Adam(params, lr=float(spec))
    return spec(params)


class GANEstimator:
    """Adversarial trainer over torch generator/discriminator modules.

    Args:
      generator: module, noise [B, noise_dim] -> sample.
      discriminator: module, sample -> logits.
      loss: name in {"minimax", "lsgan", "wasserstein"} OR a pair
        (d_loss_fn(real_logits, fake_logits), g_loss_fn(fake_logits)).
      generator_optimizer / discriminator_optimizer: a learning rate
        (Adam) or ``params -> torch.optim.Optimizer``.
      noise_dim: latent dimension sampled N(0, 1) on the device.
      d_steps: discriminator updates per generator update (WGAN-style
        n_critic).
      device: where to train (``cuda`` unless the caller names another).
    """

    def __init__(self, generator, discriminator, *,
                 loss: Any = "minimax",
                 generator_optimizer=None, discriminator_optimizer=None,
                 noise_dim: int = 64, d_steps: int = 1,
                 mesh=None, seed: int = 0, device=None):
        from analytics_zoo_tpu_torch.common.context import context_mesh
        from analytics_zoo_tpu_torch.parallel.partition import (
            data_process_groups, data_sharding)

        if mesh is None and device is None:
            mesh = context_mesh()
        self.mesh = mesh
        self._dp, self._dp_index, self._dp_group = 1, 0, None
        if mesh is not None and mesh.devices > 1:
            self._dp, self._dp_index, _ = data_process_groups(
                data_sharding(mesh))
            self._dp_group = mesh.group("dp")
            if device is None:
                device = mesh.device
        self.gen = generator
        self.disc = discriminator
        if isinstance(loss, str):
            if loss not in _LOSSES:
                raise ValueError(f"unknown GAN loss {loss!r}; "
                                 f"have {sorted(_LOSSES)}")
            self.d_loss_fn, self.g_loss_fn = _LOSSES[loss]
        else:
            self.d_loss_fn, self.g_loss_fn = loss
        self._g_spec, self._d_spec = (generator_optimizer,
                                      discriminator_optimizer)
        self.noise_dim = noise_dim
        self.d_steps = d_steps
        self.seed = seed
        self.device = resolve_device(device)
        self.state: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------

    def _ensure_state(self, sample_real: np.ndarray):
        """Move both modules to the device, give lazy layers their
        widths (a zero-noise sample through both) and make the
        optimizers."""
        if self.state is not None:
            return
        self.gen.to(self.device)
        self.disc.to(self.device)
        with torch.no_grad():
            noise = torch.zeros(1, self.noise_dim, device=self.device)
            self.disc(self.gen(noise))
            if self.mesh is not None and self.mesh.devices > 1:
                # every rank starts from rank 0's weights
                data_parallel.broadcast_start(
                    [t for m in (self.gen, self.disc)
                     for t in list(m.parameters()) + list(m.buffers())])
        self.state = {
            "g_opt": _optimizer(self._g_spec, list(self.gen.parameters())),
            "d_opt": _optimizer(self._d_spec, list(self.disc.parameters())),
            "step": 0,
        }
        n = sum(p.numel() for p in list(self.gen.parameters())
                + list(self.disc.parameters()))
        logger.info("GANEstimator init: %s params total, device=%s",
                    f"{n:,}", self.device)

    def _noise(self, step: int, i: int, b: int) -> torch.Tensor:
        """Draw ``i`` of step ``step``: ``[b, noise_dim]`` N(0, 1), f32
        (under dp this rank's ``b`` rows of the global batch's draw)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(fold_in(self.seed, step), i))
        z = torch.randn((b * self._dp, self.noise_dim), generator=gen,
                        device=self.device)
        return z[self._dp_index * b:(self._dp_index + 1) * b]

    def _dp_step(self, opt, params) -> None:
        """Average ``params``' gradients over dp, then step ``opt``."""
        if self._dp > 1:
            data_parallel.average_grads(params, (self._dp_group,), self._dp)
        opt.step()

    def _dp_mean(self, mets: Dict[str, torch.Tensor]):
        if self._dp == 1:
            return mets
        return data_parallel.mean_over(mets, self._dp_group, self._dp)

    def _step(self, real: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training step on the batch ``real``: ``d_steps``
        discriminator updates, then one generator update."""
        st = self.state
        step, b = st["step"], real.shape[0]
        d_opt, g_opt = st["d_opt"], st["g_opt"]
        for i in range(self.d_steps):
            with torch.no_grad():
                fake = self.gen(self._noise(step, i, b))
            d_opt.zero_grad(set_to_none=True)
            d_loss = self.d_loss_fn(self.disc(real), self.disc(fake))
            d_loss.backward()
            self._dp_step(d_opt, list(self.disc.parameters()))
        noise = self._noise(step, self.d_steps, b)
        g_opt.zero_grad(set_to_none=True)
        self.disc.requires_grad_(False)
        try:
            g_loss = self.g_loss_fn(self.disc(self.gen(noise)))
            g_loss.backward()
        finally:
            self.disc.requires_grad_(True)
        self._dp_step(g_opt, list(self.gen.parameters()))
        st["step"] = step + 1
        return self._dp_mean({"d_loss": d_loss.detach(),
                              "g_loss": g_loss.detach()})

    # ------------------------------------------------------------------

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_col: str = "x") -> list:
        """data: ndarray of real samples, dict with `feature_col`, XShards,
        or a creator fn (the Estimator data contract)."""
        if isinstance(data, np.ndarray):
            data = {feature_col: data}
        arrays = DataCreator.to_arrays(data)
        if feature_col in arrays:
            real = arrays[feature_col]
        elif len(arrays) == 1:
            real = next(iter(arrays.values()))
        else:
            raise KeyError(
                f"feature_col {feature_col!r} not in data columns "
                f"{sorted(arrays)} — ambiguous which one holds the real "
                "samples")
        self._ensure_state(real)
        if batch_size % self._dp:
            raise ValueError(f"global batch {batch_size} must be positive "
                             f"and divisible by data-shard group count "
                             f"{self._dp}")
        it = NumpyBatchIterator({"x": real}, batch_size, seed=self.seed)
        per = batch_size // self._dp
        history = []
        for ep in range(epochs):
            acc: list = []
            for b in it.epoch_batches():
                rows = b["x"][self._dp_index * per:(self._dp_index + 1) * per]
                x = torch.as_tensor(np.ascontiguousarray(rows),
                                    device=self.device)
                acc.append(self._step(x))
            n = len(acc)
            # one fetch an epoch: the loop never waits on the card
            stats = {k: float(torch.stack([m[k] for m in acc]).float()
                              .mean().cpu())
                     for k in (acc[0] if acc else {})}
            stats["epoch"] = ep + 1
            stats["steps"] = n
            history.append(stats)
            logger.info("GAN epoch %d: %s", ep + 1, stats)
        return history

    @torch.no_grad()
    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """Sample n outputs from the trained generator."""
        if self.state is None:
            raise RuntimeError("fit first")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        noise = torch.randn((n, self.noise_dim), generator=gen,
                            device=self.device)
        return self.gen(noise).float().cpu().numpy()
