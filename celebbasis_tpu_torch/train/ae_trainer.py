"""First-stage (autoencoder) GAN trainer: AutoencoderKL or VQModel.

Counterpart of ``celebbasis_tpu/train/ae_trainer.py``, after the
reference's ``AutoencoderKL.training_step`` / ``VQModel.training_step``: two
Adam optimizers (betas 0.5 / 0.9), a generator pass (optimizer_idx 0) and
then a discriminator pass (optimizer_idx 1) per batch, with the losses of
``train/ae_loss.py``.  The discriminator pass reconstructs again with the
*updated* generator, as Lightning's sequential optimizer steps do.

Optimizer partition, as in the reference and the JAX package: the
generator's optimizer holds the autoencoder's parameters (encoder, decoder,
quant convs, and the codebook of a VQ model) and nothing of the loss, so
``loss.logvar`` is in neither optimizer and stays at ``logvar_init``.

Both passes run as one captured step (``utils.graphs``; the JAX package's
two ``jax.jit`` steps): on a card the step is a CUDA graph captured at the
first batch and replayed after, the adaptive weight's two
``torch.autograd.grad`` calls inside it.  Both Adams are ``capturable``
there, with their state and the gradients allocated up front.  The step
reads no ``global_step``: ``adopt_weight``'s factor is resolved before the
call and passed in, so a run captures one graph before ``disc_start`` and
one after.  Randomness: the KL posterior's noise of each pass is drawn
before the step from the generator handed to ``train_batch`` (generator
pass first), or given as ``override_eps``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from celebbasis_tpu_torch.models.vq import VQModel
from celebbasis_tpu_torch.train.ae_loss import (VQLPIPSWithDiscriminator,
                                                adopt_weight)
from celebbasis_tpu_torch.train.step import allocate_state, written_in_place
from celebbasis_tpu_torch.utils import graphs


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL of the diagonal Gaussian posterior to N(0, 1), summed per
    sample."""
    return 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(
        dim=(1, 2, 3))


class AETrainer:
    """GAN-trains a first stage: ``model`` is an ``AutoencoderKL`` or a
    ``VQModel``, ``loss`` the matching (VQ)LPIPSWithDiscriminator.  The
    modules are trained in place; ``global_step`` counts batches.
    ``train_batch.eager`` is the step uncaptured (comparisons), and
    ``train_batch.captured`` its ``utils.graphs.Captured``."""

    def __init__(self, model, loss, learning_rate: float,
                 lr_g_factor: float = 1.0):
        self.model, self.loss = model, loss
        self.is_vq = isinstance(model, VQModel)
        assert self.is_vq == isinstance(loss, VQLPIPSWithDiscriminator), \
            "VQModel pairs with VQLPIPSWithDiscriminator, KL with LPIPS..."
        on_card = next(model.parameters()).is_cuda
        self.opt_g = torch.optim.Adam(model.parameters(),
                                      lr=learning_rate * lr_g_factor,
                                      betas=(0.5, 0.9), capturable=on_card)
        self.opt_d = torch.optim.Adam(loss.disc.parameters(),
                                      lr=learning_rate, betas=(0.5, 0.9),
                                      capturable=on_card)
        if on_card:
            allocate_state(self.opt_g)
            allocate_state(self.opt_d)
        self.global_step = 0
        self.train_batch = graphs.entry(self._make, self._passes,
                                        restore=self.written_in_place)

    def _reconstruct(self, x: torch.Tensor, eps):
        """-> (reconstructions, kl) for a KL model, (reconstructions,
        (codebook loss, indices)) for a VQ one."""
        if self.is_vq:
            z, emb_loss, ind = self.model.quantize(
                self.model.encode_to_prequant(x))
            aux = (emb_loss, ind)
        else:
            mean, logvar = self.model.encode(x)
            z = mean + torch.exp(0.5 * logvar) * eps
            aux = kl_divergence(mean, logvar)
        return self.model.decode(z), aux

    def _generator_pass(self, x, eps, disc_factor) -> Dict:
        recons, aux = self._reconstruct(x, eps)
        last = self.model.decoder.conv_out.weight
        if self.is_vq:
            emb_loss, ind = aux
            kw = dict(predicted_indices=ind) if self.loss.cfg.n_classes \
                else {}
            loss, log = self.loss.generator_loss(x, recons, emb_loss,
                                                 disc_factor, last, **kw)
        else:
            loss, log = self.loss.generator_loss(x, recons, aux,
                                                 disc_factor, last)
        params = [p for g in self.opt_g.param_groups for p in g["params"]]
        self.opt_g.zero_grad(set_to_none=False)
        loss.backward(inputs=params)
        self.opt_g.step()
        return log

    def _discriminator_pass(self, x, eps, disc_factor) -> Dict:
        with torch.no_grad():
            recons, _ = self._reconstruct(x, eps)
        loss, log = self.loss.discriminator_loss(x, recons, disc_factor)
        self.opt_d.zero_grad(set_to_none=False)
        loss.backward()
        self.opt_d.step()
        return log

    def _passes(self, images, eps_g, eps_d, disc_factor: float) -> Dict:
        """The generator pass, then the discriminator pass (what a graph
        holds).  ``eps_g`` / ``eps_d``: each pass's posterior noise (None
        for a VQ model)."""
        log = self._generator_pass(images, eps_g, disc_factor)
        log.update(self._discriminator_pass(images, eps_d, disc_factor))
        return log

    def latent_shape(self, images: torch.Tensor) -> tuple:
        """The posterior's (B, H/f, W/f, embed_dim) for ``images``."""
        cfg = self.model.cfg
        f = 2 ** (len(cfg.ch_mult) - 1)
        B, H, W = images.shape[:3]
        return (B, H // f, W // f, cfg.embed_dim)

    def _make(self, run):
        def train_batch(images: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        override_eps: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
            """One batch: the generator pass, then the discriminator pass.
            ``images`` (B, H, W, 3) in [-1, 1] on the model's device.  ->
            both passes' logs (detached tensors)."""
            eps_g = eps_d = None
            if override_eps is not None:
                eps_g, eps_d = override_eps
            elif not self.is_vq:
                shape = self.latent_shape(images)
                eps_g, eps_d = (torch.randn(shape, generator=generator,
                                            device=generator.device)
                                .to(images.device) for _ in range(2))
            cfg = self.loss.cfg
            log = run(images, eps_g, eps_d, adopt_weight(
                cfg.disc_factor, self.global_step, cfg.disc_start))
            self.global_step += 1
            return log
        return train_batch

    def written_in_place(self) -> list:
        """What a step writes in place: both modules' trained parameters,
        their gradients and both Adams' state (the discriminator's norms
        keep no running statistics)."""
        return written_in_place(self.opt_g) + written_in_place(self.opt_d)

    def state_dict(self) -> Dict:
        """Everything a resumed run needs: both modules, both optimizers and
        the step."""
        return {"model": self.model.state_dict(),
                "loss": self.loss.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(),
                "global_step": self.global_step}

    def load_state_dict(self, state: Dict) -> None:
        """Everything in place but the optimizers' state, which a loaded
        state dict replaces: call before the first batch (a captured step
        reads the tensors it was captured with)."""
        self.model.load_state_dict(state["model"])
        self.loss.load_state_dict(state["loss"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.global_step = int(state["global_step"])
