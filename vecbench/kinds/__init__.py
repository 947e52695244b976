"""Ways of driving the system, one module each, named by a workload's
``kind``.  Each has three functions:

- ``setup(ctx)``: makes the inputs from the seed, sets the system up and
  warms up every shape the window uses; returns its state;
- ``window(ctx, state, seconds)``: drives the system for ``seconds``,
  filling ``ctx.run``;
- ``check(ctx, state)``: gathers what the window produced, frees the
  program's state and returns the judge's :class:`vecbench.judge.Verdict`.
"""
