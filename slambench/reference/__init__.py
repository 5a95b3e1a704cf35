"""Plain references of the benchmark's configurations, one module each.

A configuration file (``slambench/configs/<name>.json``) names its module
under ``reference``; the harness finds it as ``slambench.reference.<name>``
(``check.reference_module``) and takes from it everything that depends on
the configuration's depth network, so that a configuration with another
network brings a module of its own and edits no file of the harness. Every
such module provides:

  * ``check_supported(cfg)``: raises unless every setting of the
    configuration's ``config`` that the reference reads has a value it
    implements;
  * ``network_shapes()``: ``(name, shape, kind)`` of every tensor of the
    network, named as the port's network's state dict names it (the
    harness builds that network from ``MODEL.depth_network`` and
    ``MODEL.num_layers`` and loads the seeded tensors into it strictly);
    ``kind`` is ``conv``, ``bias``, ``bn_weight``, ``bn_bias``,
    ``bn_mean``, ``bn_var`` or ``bn_count`` (``weights.py`` draws each by
    its kind);
  * ``flops_per_event(height, width, frames, steps)``: the model FLOPs of
    one keyframe event (``metrics/mfu.py`` reads them per step);
  * ``keyframe_schedule(poses, threshold)``: ``[(prev, cur), ...]``, the
    events of a sequence;
  * ``first_event``, ``follow_event``, ``fused_depth``, ``fuse`` and
    ``CONTROLS``, as ``check.py`` calls them (``online_pft.py``'s
    docstrings give their arguments and results), and ``project``, which
    ``check.fusion_numbers`` calls.

A reference imports nothing of the program and nothing of ``slambench``:
it is plain PyTorch and NumPy, so that it can judge the program. The next
configuration's reference starts as a copy of ``online_pft.py`` with its
own network.
"""
