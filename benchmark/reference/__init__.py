"""Plain PyTorch reference of what the benchmark's cells run.

The DiT-L/2 and VDM-UNet denoisers (forward; the backward is autograd's),
the BSI training loss with EDM preconditioning, the sampler's steps, AdamW
with global-norm clipping and the EMA, written from the models' and the
algorithm's definitions in plain ``torch`` operations, f32 by default. It
imports neither ``jax``, the JAX package nor ``bsi_torch``: it takes the
benchmark's weights, data and seeds and works out every draw again
(:mod:`.draws`).

A :class:`~.layers.Precision` turns the products (dense layers,
convolutions, attention's two products) into the control's lower
precision: fp8 operands for the bf16 cells; the f32 cells' control is TF32,
which is a flag of the backends (:func:`~.layers.tf32`).
"""
