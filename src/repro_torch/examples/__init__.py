"""The README's example entry points on the port.

Each module is the counterpart of the JAX package's ``examples/<name>.py``,
with its stages, seeds and printed lines, run as ``python -m
repro_torch.examples.<name>``:

- ``quickstart``: decompose gpt3-xl, run the campaign, plan with three
  governors, save and reload the ``DvfsPlan`` (host only);
- ``plan_transfer``: one plan carried across data and tensor parallelism
  (host only);
- ``fleet_serve``: one trace routed three ways, a cluster power cap, a
  parked replica (host only, modeled time);
- ``serve_dvfs``: llama3.2-1b served behind an executed per-phase plan,
  then the online governor on a drifted mix (builds a model: ``--device``);
- ``train_gpt3xl_dvfs``: gpt3-xl trained behind an executed plan through a
  checkpoint, an injected failure and a restart (builds a model).

Every example takes ``--chip`` (a name in ``core.power_model.CHIPS``,
``h100`` by default): the times, energies and watts it derives from a chip
model are modeled, not readings of a card, and its first line names that
chip model.  The two that build a model take ``--device`` (``cuda`` by
default, which raises without a card; ``cpu`` runs the reference's sizes on
the kernels' plain versions).  Each ``main(argv)`` returns what it printed.
Artifacts go to ``artifacts/torch_*``.
"""
