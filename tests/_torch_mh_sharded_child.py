"""Child process of the port's 2-process sharded-scan pod
(tests/test_torch_multiprocess.py): ``reduce_scan_sharded_to_files``
run for real under ``torch.distributed`` with gloo, each process feeding
only its own players' files and writing only its own band rows.

Run as: ``python tests/_torch_mh_sharded_child.py <pid> <nproc> <port>
<outdir> <nband> <nbank>``.  With ``nband=1`` the band row spans both
processes, so the bank stitch gathers across them.  The parent
byte-compares the products with the pool oracle over the same seeded
scan.
"""

import json
import os
import sys


def main() -> None:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    nband, nbank = int(sys.argv[5]), int(sys.argv[6])
    from blit_torch.parallel import multihost

    active = multihost.init_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
        process_id=pid, backend="gloo", device="cpu")
    assert active and multihost.process_count() == nproc
    with open(os.path.join(outdir, f"ready{pid}"), "w"):
        pass

    from blit_torch.observability import Timeline
    from blit_torch.parallel import mesh as M
    from blit_torch.parallel.sharded import reduce_scan_sharded_to_files
    from blit_torch.testing import synth_raw

    nfft, nint, nchan = 32, 2, 2
    mesh = M.make_mesh(nband, nbank, devices=["cpu"] * (nband * nbank // nproc))
    local = sorted(mesh.local_players())
    # Only this process's players' files exist here: the other entries
    # of the grid name files the feed must never touch.
    priv = os.path.join(outdir, f"proc{pid}")
    os.makedirs(priv, exist_ok=True)
    bank_bw = -187.5 / nbank
    paths = [[os.path.join(priv, f"blc{b}{k}.raw") for k in range(nbank)]
             for b in range(nband)]
    for b, k in local:
        synth_raw(paths[b][k], nblocks=2, obsnchan=nchan, ntime_per_block=512,
                  seed=b * 8 + k, tone_chan=k % nchan, obsbw=bank_bw,
                  obsfreq=8000.0 + b * 500.0 + (k + 0.5) * bank_bw)
    prod = os.path.join(outdir, "products")
    os.makedirs(prod, exist_ok=True)
    tl = Timeline()
    written = reduce_scan_sharded_to_files(
        paths, out_dir=prod, nfft=nfft, nint=nint, despike=True,
        window_frames=4, mesh=mesh, timeline=tl, probe_windows=2)
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump({"local": [list(x) for x in local],
                   "bands": sorted(written),
                   "nsamps": {str(b): int(h["nsamps"])
                              for b, (_, h) in written.items()},
                   "ici_calls": tl.stages["mesh.ici"].calls,
                   "ici_bytes": tl.stages["mesh.ici"].bytes,
                   "gather_s_n": tl.hists["mesh.gather_s"].n}, f)
    multihost.shutdown()
    print("CHILD-SHARDED-OK", flush=True)


if __name__ == "__main__":
    main()
