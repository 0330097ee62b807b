"""blit_torch.parallel — worker pools (host fan-out) and the ``(band,
bank)`` mesh (the collective data plane).

Counterpart of ``blit.parallel``: ``pool`` / ``remote`` are the control
plane; ``mesh`` (players, the stitch, the psum), ``multihost`` (the
``torch.distributed`` pod), ``scan`` / ``sharded`` (whole scans over the
mesh), and the antenna-array plane (``antenna``, ``beamform``,
``correlator``, each on one card with ``device=`` or over the mesh with
``mesh=``) are the data plane.  Importing this package starts no
process group.
"""
