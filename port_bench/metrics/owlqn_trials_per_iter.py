"""OWL-QN's line-search trials per iteration over the run's solves, set-up
included: the port's ``owlqn.trials`` over ``owlqn.iterations``
(``optimize/owlqn.py``). Each trial is one forward pass over the data.
None where the port counts neither."""

from port_bench.entries import registry


def read(name, ctx):
    c = registry.counters("owlqn.trials", "owlqn.iterations")
    if c is None or not c["owlqn.iterations"]:
        return None
    return c["owlqn.trials"] / c["owlqn.iterations"]
