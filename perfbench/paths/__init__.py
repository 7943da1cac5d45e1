"""One module a training path, named by a traffic file's ``path``: how the
user's program drives its train step.

Each gives ``make(target, inner, loss_fn, named, spans)`` -> ``(optimizer,
step)``: ``target`` is what ``loss_fn(target, batch)`` trains (a module or
a dict of tensors), ``inner`` the plain ``torch.optim`` optimizer over its
parameters, ``named`` the ``(name, parameter)`` pairs to hand the
program's distributed optimizer (or None), ``spans`` a dict the path may
add host spans to (``name -> [seconds, count]``); ``step(batch)`` runs one
train step and returns its loss on the device; ``LOSS_OVER`` says over
what: ``"world"`` (averaged over the ranks) or ``"rank"`` (this rank's
rows).  A new path is a new file here, found by its name.
"""

import importlib


def load(name: str):
    return importlib.import_module(f"perfbench.paths.{name}")
