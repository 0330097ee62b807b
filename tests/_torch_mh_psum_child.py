"""Child process of the port's 2-process psum pod
(tests/test_torch_multiprocess.py): the band-axis psums of the array
plane under ``torch.distributed`` with gloo.  On a ``(2, 4)`` mesh, one
band row a process, ``beamform(mesh, axis="band")`` splits the antennas
over ``band`` and ``correlate(mesh)`` the time segments over ``band``,
so both sums cross the processes.

Run as: ``python tests/_torch_mh_psum_child.py <pid> <nproc> <port>
<outdir>``.  Every process builds the same seeded inputs and saves the
whole results; the parent holds them against blit's NumPy goldens.
"""

import os
import sys


def main() -> None:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    import numpy as np
    import torch

    from blit_torch.parallel import multihost

    multihost.init_multihost(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=nproc, process_id=pid,
                             backend="gloo", device="cpu")
    with open(os.path.join(outdir, f"ready{pid}"), "w"):
        pass

    from blit_torch.ops.channelize import pfb_coeffs
    from blit_torch.parallel import beamform as TB
    from blit_torch.parallel import correlator as TC
    from blit_torch.parallel import mesh as M

    mesh = M.make_mesh(2, 4, devices=["cpu"] * (8 // nproc))
    rng = np.random.default_rng(11)
    nant, nchan, ntime, npol, nbeam = 8, 4, 512, 2, 3
    v = (rng.integers(-20, 21, (nant, nchan, ntime, npol))
         + 1j * rng.integers(-20, 21, (nant, nchan, ntime, npol))).astype(np.complex64)
    w = (rng.standard_normal((nbeam, nant, nchan))
         + 1j * rng.standard_normal((nbeam, nant, nchan))).astype(np.complex64)
    power = TB.beamform(torch.from_numpy(v), torch.from_numpy(w), nint=4,
                        mesh=mesh, axis="band")
    vis = TC.correlate(torch.from_numpy(v), pfb_coeffs(4, 32), nfft=32, ntap=4,
                       mesh=mesh)
    np.save(os.path.join(outdir, f"power{pid}.npy"), power.numpy())
    np.save(os.path.join(outdir, f"vis{pid}.npy"), vis.numpy())
    multihost.shutdown()
    print("CHILD-PSUM-OK", flush=True)


if __name__ == "__main__":
    main()
