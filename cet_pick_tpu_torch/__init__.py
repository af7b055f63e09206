"""cet_pick_tpu_torch — the PyTorch/CUDA port of ``cet_pick_tpu``.

The port keeps the JAX package's module layout and names so that each
counterpart is easy to find; inside, it is PyTorch idiom (``nn.Module``s,
plain functions on tensors, an explicit ``device``). Entry points run on
``cuda`` unless the caller asks for ``cpu``.

The package imports ``torch`` and never ``jax``, ``flax`` or anything of
``cet_pick_tpu``: the numpy-only modules it needs are copied here, and each
copy's docstring names the JAX file it came from.
"""
