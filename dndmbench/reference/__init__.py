"""The plain reference that decides ``correct``: plain PyTorch, float32
with TF32 off.  It imports nothing of ``jax``, ``repro`` or
``repro_torch``, and works out again whatever the program derives from
the benchmark's inputs (transition-time law, draws, tokens).

``sampler.py`` replays the DNDM sampler's law and random stream; the
forward it checks against is the configuration's reference, the module
of this package that the configuration file names under ``"reference"``
(``model.py`` when it names none).  A reference module defines:

* ``expand(c) -> dict``: the file's ``model`` widths with the derived
  ones filled in (``block_pattern`` among them); the harness replaces
  them onto the port's config and hands them to the metric readers;
* ``param_shapes(c) -> {path: shape}``: every parameter the port's model
  holds, in the checkpoint layout that ``convert.load_params`` loads and
  in the order ``weights.make`` draws them;
* ``forward(tree, c, tokens, t) -> logits``: tokens (B, S) int, t (B,)
  diffusion time in [0, 1], logits (B, S, V) float32;
* ``precision(kind, device)``: a context manager under which ``forward``
  computes its products in ``kind``, "float32" (TF32 off) or "tf32" (the
  control);
* optionally ``leaf_rule(path, shape, c)``: ``(kind, scale, offset)`` of
  a leaf's law, as ``weights._leaf_rule`` gives it, or None for the
  default laws.

A reference of a configuration with top-K routed layers, where a choice
flips between the program and the reference at rounding, also defines
(``routing.py`` says why, and its ``Route`` does the choosing):

* ``forward_routed(tree, c, tokens, t, routing) -> (logits, shortfall)``:
  ``routing`` holds one (B, S, K) id tensor per routed layer, in the
  order the forward reaches them, the program's choices.  Each routed
  layer runs the reference's own router, then computes with those
  experts, gated by the reference's own scores at them.  ``shortfall``
  is the largest, over tokens and layers, of the reference's K-th best
  selection score less the score of a chosen expert, floored at 0;
  ids that repeat or fall out of range, or layers that do not match,
  give ``inf``;
* ``forward_chosen(tree, c, tokens, t) -> (logits, routing)``: the
  forward on its own choices, and those choices, as ``forward_routed``
  takes them (the control records them as the program's).

Such a configuration is routed: the harness records the program's
choices (``dndmbench/routes.py``) and the checks force them in.

A new reference imports ``precision``, ``mm``, ``rmsnorm``,
``attention``, ``mlp``, ``ssd``, ``time_embed`` and the other helpers of
``model.py``, so that every configuration has the one TF32 control.
"""
