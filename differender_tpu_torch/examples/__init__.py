"""The example scripts of the JAX package (``examples/``), ported: each runs
as ``python -m differender_tpu_torch.examples.<name>`` with the JAX
script's flags and defaults, on the card unless ``--cpu`` is given (the
plain torch versions).  Each puts its work in ``run(args)``, which returns
the arrays it would write; ``main`` writes the files (PNG, GIF and AVI
through PIL and matplotlib, which the work itself never imports).

* :mod:`.render_nondiff`: the inference render of a volume (800^2,
  sampling rate 16, 4 row strips).
* :mod:`.optimize_tf`: TF recovery with the reference's momentum optimizer
  (``backward``), or an orbit animation (``forward``).
* :mod:`.optimize_tf_torch`: TF recovery in a plain torch loop on
  :class:`~differender_tpu_torch.TorchRaycaster`.
* :mod:`.optimize_volume`: volume inverse rendering over several views a
  step, with checkpoints and ``--resume``.
* :mod:`.interactive_viewer`: an orbit viewer served over HTTP on
  127.0.0.1.
"""
