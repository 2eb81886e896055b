"""Model families: everything of the benchmark that depends on the model.

A configuration names its family in ``model.family`` (``"gcn"`` where it
names none); ``registry.family`` loads ``families/<family>.py`` by that name,
so a new model enters the benchmark as a new file here beside its
configuration, traffic and workload files. A family module gives:

* ``NUMBERS``: the names of the numbers its comparison gives, which a cell's
  ``limits`` name exactly; ``FAULTS``: the faults ``follow`` can plant;
  ``CONTROL``: the precision of the comparison's control, the nearest below
  the configuration's;
* ``prepare(config, traffic, data, device)``: what every job of a run
  shares, built through the program's entry points;
* ``run_job(prep, seed) -> (epochs, finite)``: one job of the window;
* ``check_steps(prep, data, seed)``: a job's first steps through the
  window's own calls, read for the comparison;
* ``reference_inputs(data, config, traffic, device)`` and
  ``follow(inputs, config, seed, readings, precision="float32", fault=None)``:
  the plain reference over the same steps, in float32 with TF32 off (or at
  ``precision``, or with ``fault`` planted), which imports nothing of the
  program and nothing of JAX and takes of the program's ``readings`` only
  what the program drew at random (dropout masks);
* ``numbers(prog, ref) -> {name: value}``: the compared numbers, keyed by
  ``NUMBERS``;
* ``shapes(prep, data, config, traffic)`` and
  ``job_work(shapes, epochs, early_stopping) -> {part: roofline.Work}``: a
  job's least work by part, ``"total"`` among them, which the per-layer
  metrics read by name (``run.Context.least_s``).
"""
