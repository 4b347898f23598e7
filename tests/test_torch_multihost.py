"""Runs of the port over two OS processes (``parallel/multihost.py``), as
``tests/test_multihost.py`` runs the JAX package's.

Each process starts its share of the ranks (``RankPool`` with
``local``/``rank_offset``); all of them rendezvous at process 0's
``tcp://localhost:<port>``, a port taken from ``bind(("", 0))``.

* The library: a (time=2, space=2) global mesh over two processes of two
  CPU ranks each; each process stages its own time slab
  (``stage_global_cube``) and the Ulysses-sharded 3-D filter runs over
  the whole mesh, against the JAX package's single-device
  ``fused_filter_3d`` (1e-4, ``tests/test_multihost.py``'s bound).
* The motion CLI through ``--coordinator/--nprocs/--proc-id`` (``-b 0x0x0``
  over space=2,time=2): process 0 writes the file, which equals the JAX
  tool's single-device output within 1e-5 and the port's own
  single-device output within 1e-5.
"""

import os
import socket
import subprocess
import sys
from fractions import Fraction

import numpy as np

from dspfun_tpu.core.precision import Precision as JPrecision
from dspfun_tpu.io import video
from dspfun_tpu.models.fused import filter_plans, fused_filter_3d, lowpass_mask
from dspfun_tpu.tools import motion as jmotion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LIB_WORKER = r'''
import sys
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import torch_mesh_cases as cases
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.parallel import multihost
from dspfun_tpu_torch.parallel.mesh import RankPool

def main():
    rng = np.random.default_rng(0)
    full = rng.random((8, 4, 6, 3)).astype(np.float32)
    mask = np.load(out + ".mask.npy")
    with RankPool(["cpu"] * 4, local=2, rank_offset=2 * pid,
                  init_method=f"tcp://localhost:{port}") as pool:
        mesh = multihost.global_mesh(space=2, time=2, devices=["cpu"] * 4, num_processes=2)
        res = pool.run(cases.multihost_fused3d, mesh, full, mask,
                       Precision(coeff="float32", intermediate="f32"))
    if pid == 0:
        np.save(out, res[0])
    print(f"proc {pid} OK", flush=True)

if __name__ == "__main__":
    main()
'''

CLI_WORKER = r'''
import sys
pid, port, src, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from dspfun_tpu_torch.tools import motion

if __name__ == "__main__":
    rc = motion.main(["--device", "cpu", "-Q", "-b", "0x0x0", "-p", "2x2x2", "-D", "0.5",
                      "--mesh", "space=2,time=2", "--coordinator", f"localhost:{port}",
                      "--nprocs", "2", "--proc-id", str(pid), src, out])
    assert rc == 0, rc
    print(f"proc {pid} OK", flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(tmp_path, code, *args):
    worker = tmp_path / "worker.py"
    worker.write_text(code)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])}
    env.pop("DSPFUN_MESH", None)
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=str(tmp_path))
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out


def test_two_process_sharded_dct(tmp_path):
    t, h, w = 8, 4, 6
    mask = lowpass_mask((t, h, w), cutoff=0.5, boost=1.25, damp=0.1)[..., None].astype(np.float32)
    out = str(tmp_path / "out.npy")
    np.save(out + ".mask.npy", mask)
    _run_two(tmp_path, LIB_WORKER, out)
    full = np.random.default_rng(0).random((t, h, w, 3)).astype(np.float32)
    prec = JPrecision(coeff="float32", intermediate="f32")
    ref = np.asarray(fused_filter_3d(full, mask, filter_plans((t, h, w), prec), prec))
    np.testing.assert_allclose(np.load(out), ref, atol=1e-4)


def _clip(path):
    with video.open_input(path) as r:
        got = []
        while (f := r.read_frame_rgb()) is not None:
            got.append(f)
    return np.stack(got)


def test_motion_cli_two_process(tmp_path):
    from dspfun_tpu_torch.tools import motion as tmotion

    rng = np.random.default_rng(31)
    src = str(tmp_path / "in.fvid")
    props = video.parse_color_props("pixel_format=gbrpf32le")
    with video.open_output(src, 16, 8, Fraction(25), props, format="fvid") as wr:
        for f in rng.random((8, 8, 16, 3)).astype(np.float32):
            wr.write_frame_rgb(f)
    args = ["-Q", "-b", "0x0x0", "-p", "2x2x2", "-D", "0.5", src]
    ref, one = str(tmp_path / "ref.fvid"), str(tmp_path / "one.fvid")
    assert jmotion.main(args + [ref]) == 0
    assert tmotion.main(["--device", "cpu"] + args + [one]) == 0
    out = str(tmp_path / "multi.fvid")
    _run_two(tmp_path, CLI_WORKER, src, out)
    got = _clip(out)
    np.testing.assert_allclose(got, _clip(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _clip(one), atol=1e-5, rtol=1e-5)
