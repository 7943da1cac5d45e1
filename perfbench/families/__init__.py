"""One module a model family, named by a configuration's ``family``.

Each gives ``Program(config, traffic, seed, device, rank, world)``
(``step(i)`` -> the loss of the program's train step on batch ``i`` of
rank ``rank``'s pool; ``first_grads()``, ``state()``, ``items_per_step``,
``spans``, ``free()``),
``initial_state``, ``split`` (a tensor into its leaves), ``reference``
(the plain reference's first steps, as rank 0 of ``world`` sees them ->
``perfbench.check.Readings``) and optionally ``kinds`` (leaf -> kind, for
``check``'s ``change.<kind>``).
"""
