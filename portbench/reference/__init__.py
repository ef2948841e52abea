"""The plain PyTorch reference of the benchmark's configurations: float32
nets, losses, pools and Adam, importing nothing of the program.

A configuration file names its reference class in ``reference``: '<path of
a module from the checkout's root> <class>', e.g.
'portbench/reference/train.py CGAN'; the harness imports the module by
that path (harness.recipe_class).  A reference class keeps this contract:

  Recipe(flags, device, pool_seed=0)
      built from the configuration's flags (the option names of the
      reference's train.py, without the dashes), on ``device`` (the
      benchmark's card, the CPU, or 'meta' for the FLOP count); its pools
      draw their decisions from one CPU generator seeded with
      ``pool_seed``, as the program's pools draw theirs.
  nets
      an ordered {label: nn.Module}, keyed as the program's
      ``model.nets()``, each built from reference/nets.py's ``Conv`` and
      ``BatchNorm`` (with its other modules), so that ``weights.make``
      (``nets.init_specs``) sees every parameter and buffer, in the
      program's state_dict layout; the benchmark writes the same seeded
      weights into them and into the program.
  pool_size, pool_shapes(), fill_pools(images)
      the images each pool holds, {pool name: (C, H, W)} keyed as the
      program's ``model.pools``, and the pools started full of
      ``images`` {pool name: (pool_size, C, H, W)}.
  step(batch, ctx)
      one train iteration on ``batch`` ({'A': label channels, 'B': image
      channels}, NCHW float32), its random draws from ``ctx`` (ctx.py);
      returns {name: loss tensor} under the program's
      ``get_current_errors()`` names.
  first_moments(), named_params(), optimizers()
      after the first iteration, Adam's first moment of every parameter
      it stepped; every parameter; and the Adams, each keyed
      '<net label>.<parameter name>' where keyed.

reference/train.py's ``Recipe`` implements the shared part (pools, moments,
parameters); a subclass adds the nets, pools, optimizers and step.
"""
