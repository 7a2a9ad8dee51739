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

Both passes run eagerly (not captured as CUDA graphs): the adaptive weight
takes two ``torch.autograd.grad`` calls inside the generator pass.
Randomness: the KL posterior's noise of each pass comes from the generator
handed to ``train_batch`` (generator pass first), or from ``override_eps``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from celebbasis_tpu_torch.models.vae import sample_posterior
from celebbasis_tpu_torch.models.vq import VQModel
from celebbasis_tpu_torch.train.ae_loss import VQLPIPSWithDiscriminator


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL of the diagonal Gaussian posterior to N(0, 1), summed per
    sample."""
    return 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(
        dim=(1, 2, 3))


class AETrainer:
    """GAN-trains a first stage: ``model`` is an ``AutoencoderKL`` or a
    ``VQModel``, ``loss`` the matching (VQ)LPIPSWithDiscriminator.  The
    modules are trained in place; ``global_step`` counts batches."""

    def __init__(self, model, loss, learning_rate: float,
                 lr_g_factor: float = 1.0):
        self.model, self.loss = model, loss
        self.is_vq = isinstance(model, VQModel)
        assert self.is_vq == isinstance(loss, VQLPIPSWithDiscriminator), \
            "VQModel pairs with VQLPIPSWithDiscriminator, KL with LPIPS..."
        self.opt_g = torch.optim.Adam(model.parameters(),
                                      lr=learning_rate * lr_g_factor,
                                      betas=(0.5, 0.9))
        self.opt_d = torch.optim.Adam(loss.disc.parameters(),
                                      lr=learning_rate, betas=(0.5, 0.9))
        self.global_step = 0

    def _reconstruct(self, x: torch.Tensor, generator, eps):
        """-> (reconstructions, kl) for a KL model, (reconstructions,
        (codebook loss, indices)) for a VQ one."""
        if self.is_vq:
            z, emb_loss, ind = self.model.quantize(
                self.model.encode_to_prequant(x))
            aux = (emb_loss, ind)
        else:
            mean, logvar = self.model.encode(x)
            z = (mean + torch.exp(0.5 * logvar) * eps if eps is not None
                 else sample_posterior(generator, mean, logvar))
            aux = kl_divergence(mean, logvar)
        return self.model.decode(z), aux

    def _generator_pass(self, x, generator, eps) -> Dict:
        recons, aux = self._reconstruct(x, generator, eps)
        last = self.model.decoder.conv_out.weight
        if self.is_vq:
            emb_loss, ind = aux
            kw = dict(predicted_indices=ind) if self.loss.cfg.n_classes \
                else {}
            loss, log = self.loss.generator_loss(x, recons, emb_loss,
                                                 self.global_step, last, **kw)
        else:
            loss, log = self.loss.generator_loss(x, recons, aux,
                                                 self.global_step, last)
        params = [p for g in self.opt_g.param_groups for p in g["params"]]
        self.opt_g.zero_grad()
        loss.backward(inputs=params)
        self.opt_g.step()
        return log

    def _discriminator_pass(self, x, generator, eps) -> Dict:
        with torch.no_grad():
            recons, _ = self._reconstruct(x, generator, eps)
        loss, log = self.loss.discriminator_loss(x, recons, self.global_step)
        self.opt_d.zero_grad()
        loss.backward()
        self.opt_d.step()
        return log

    def train_batch(self, images: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    override_eps: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
        """One batch: the generator pass, then the discriminator pass.
        ``images`` (B, H, W, 3) in [-1, 1] on the model's device.  ->
        both passes' logs (detached tensors)."""
        eps_g, eps_d = override_eps if override_eps is not None \
            else (None, None)
        log = self._generator_pass(images, generator, eps_g)
        log.update(self._discriminator_pass(images, generator, eps_d))
        self.global_step += 1
        return log

    def state_dict(self) -> Dict:
        """Everything a resumed run needs: both modules, both optimizers and
        the step."""
        return {"model": self.model.state_dict(),
                "loss": self.loss.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(),
                "global_step": self.global_step}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.loss.load_state_dict(state["loss"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.global_step = int(state["global_step"])
