"""The port's two examples run through to their end on the CPU, and the
sharded train step's microbatch split on gloo ranks (``tests/_ranks.py``):

- ``examples.train_e2e``: two steps of vit-b16's smoke config, a simulated
  restart and the resume, whose losses continue the uninterrupted run's;
- ``examples.elastic_failover`` on 4 ranks: the checkpoint saved on (2,2),
  the last rank failed by the heartbeat monitor, restored with
  ``shardings=`` on the survivors' (1,2) mesh bit for bit, the straggler
  flagged and the uplink-dead failover to device-only;
- ``steps._microbatches`` on a (4,1) mesh: microbatch ``i`` of a
  batch-sharded leaf is rows ``i*B/accum`` to ``(i+1)*B/accum`` of the global
  batch, each rank holding its quarter, with accumulations that do and do
  not divide by the ranks (unequal all-to-all splits).
"""
import numpy as np

from _ranks import run_ranks
from repro_torch.examples import train_e2e
from repro_torch.launch import train
from test_torch_train import LOSS_RTOL
import torch

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)


def test_train_e2e_trains_restarts_and_resumes(tmp_path, capsys):
    first, second = train_e2e.main(["--steps", "2", "--device", "cpu",
                                    "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "--- simulated restart" in out and "[train] resumed from step 1" in out
    assert (first.start_step, len(first.losses)) == (0, 1)
    assert (second.start_step, len(second.losses)) == (1, 1)
    ref = train.main(["--arch", "vit-b16", "--steps", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "ref")])
    np.testing.assert_allclose(first.losses + second.losses, ref.losses, rtol=LOSS_RTOL)


_FAILOVER = """
import contextlib, io
from repro_torch.examples import elastic_failover
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    res = elastic_failover.main(["--device", "cpu", "--ckpt-dir", os.path.join(OUT, "ck")])
open(os.path.join(OUT, f"stdout{RANK}.txt"), "w").write(buf.getvalue())
if RANK < 2:  # the survivors' mesh
    assert sorted(res["restored"]) == ["step", "table", "wq"], res["restored"]
else:
    assert res["restored"] == {}
assert list(res["stragglers"]) == ["host3"], res["stragglers"]
assert res["decisions"] and all(split == 25 for _, split in res["decisions"]), res
dist.destroy_process_group()
"""


def test_elastic_failover_restores_on_the_survivors_mesh(tmp_path):
    run_ranks(_FAILOVER, 4, tmp_path)
    out = (tmp_path / "stdout0.txt").read_text()
    assert "saved on mesh (2, 2); failed ['rank3']; 3 survivors" in out
    assert "mesh (data=1, model=2) = 2 devices" in out
    assert "restored step 1 on mesh (1, 2)" in out and "every leaf bit-equal: True" in out
    for r in range(1, 4):
        assert (tmp_path / f"stdout{r}.txt").read_text() == ""  # rank 0 alone prints


_MICROBATCHES = """
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import rules
mesh = make_host_mesh(model=1, device="cpu")
assert tuple(mesh.shape) == (4, 1), mesh
for accum, dtype in ((2, torch.float32), (3, torch.int32), (4, torch.float32)):
    g = torch.arange(4 * accum * 2 * 3).reshape(4 * accum * 2, 3).to(dtype)
    x = rules.place(g, mesh, (Shard(0), Replicate()))
    mbs = steps._microbatches(x, accum)
    m = g.shape[0] // accum
    for i, mb in enumerate(mbs):
        assert isinstance(mb, DTensor) and tuple(mb.placements) == tuple(x.placements)
        assert mb.to_local().shape == (m // 4, 3), mb.to_local().shape
        assert torch.equal(rules.to_global(mb), g[i * m:(i + 1) * m]), (accum, i)
dist.destroy_process_group()
"""


def test_microbatches_of_a_sharded_batch_are_the_global_rows(tmp_path):
    run_ranks(_MICROBATCHES, 4, tmp_path)
