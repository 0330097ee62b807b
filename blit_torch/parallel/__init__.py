"""blit_torch.parallel — the antenna-array plane on one card.

Counterpart of the array part of ``blit.parallel``: per-antenna GUPPI RAW
feeds (:mod:`~blit_torch.parallel.antenna`), tied-array beamforming
(:mod:`~blit_torch.parallel.beamform`) and the FX correlator
(:mod:`~blit_torch.parallel.correlator`).  ``blit`` runs them over a
``jax.sharding.Mesh``; here the entry points take ``device=`` and no
mesh: on one card every psum is the identity, each device holds the
whole antenna axis (so detection fuses into the beamformer), and a
correlator run is one band segment.  The sharded forms come with the
``torch.distributed`` mesh (ROADMAP.md Queue 1 item 6).
"""
