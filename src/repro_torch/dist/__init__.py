"""``repro_torch.dist`` — named meshes, their collectives and the AM specs.

Port of the parts of :mod:`repro.dist` the multi-bank search needs:

* :mod:`repro_torch.dist.mesh` — :class:`LocalMesh` (banks as slices of
  one device) and :class:`ProcessGroupMesh` (one bank per
  ``torch.distributed`` rank), each with ``axis_index``, ``all_gather``,
  ``ppermute`` and ``psum`` over a named axis.
* :mod:`repro_torch.dist.specs` — :class:`Rules` and :func:`make_rules`,
  the reference's axis bindings of the associative-memory tensors
  (``am_table``, ``am_queries``, ``am_queries_dp``, ``am_meta``,
  ``am_index``) as tuples of axis names.

* :mod:`repro_torch.dist.pipeline` — the GPipe forward over the ``pod``
  axis (``make_pp_forward``, ``bubble_fraction``).

Not here: :mod:`repro.dist.compat` bridges one JAX release's mesh API to
another's and has no PyTorch counterpart; ``constrain`` and the LM roles
of ``Rules`` come with multi-card training (ROADMAP item 11c).
"""

from repro_torch.dist.mesh import LocalMesh, ProcessGroupMesh  # noqa: F401
from repro_torch.dist.specs import Rules, make_rules  # noqa: F401
