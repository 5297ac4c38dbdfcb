"""range_tpu_torch never imports jax, not even indirectly: serving (dense,
the two-level top-k and feature path, the tail_super flagship, a sel_lr and
topk_lr bank's build and serving, dedup and the rescue), the sharded
module, pruned and hybrid retrieval over a clustered bank, and a training
step."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = ("import sys, range_tpu_torch\n"
            "import range_tpu_torch.api, range_tpu_torch.convert.from_jax\n"
            "import range_tpu_torch.kernels._build\n"
            "import torch, range_tpu_torch.train.fit\n"
            "from range_tpu_torch.train import satclip as tr\n"
            "from range_tpu_torch.models.resnet_std import StdResNetConfig\n"
            "from range_tpu_torch.models.satclip import SatClipLocationConfig\n"
            "enc = range_tpu_torch.load_model('RANGE+', db_path='synthetic:300', "
            "device='cpu', chunk=256)\n"
            "assert enc([[0.0, 0.0]]).shape == (1, 1280)\n"
            "from range_tpu_torch.ops import retrieval_hier as rh\n"
            "b = range_tpu_torch.GeoBank.synthetic_informative(0, 1500, value_dim=128, "
            "pad_to=512, device='cpu')\n"
            "hb = rh.build_hier_bank(b, bn=128, gsz_sem=8, gsz_geo=16, gsz_super=16)\n"
            "q = torch.nn.functional.normalize(torch.randn(4, 256), dim=1)\n"
            "assert rh.hier_topk(q, None, hb, k=2, k_tiles=2, bm=128).shape == (4, 2)\n"
            "ts = range_tpu_torch.load_model('RANGE+', db_path=b, device='cpu', "
            "profile='flagship', hier_bn=128, gsz_geo=16, tail_super=32, m_corr=2)\n"
            "assert ts([[0.0, 0.0]]).shape == (1, 384)\n"
            "import range_tpu_torch.parallel.sharded\n"
            "from range_tpu_torch.bank.clustered import cluster_bank\n"
            "from range_tpu_torch.ops.retrieval_fused import retrieve_hybrid, "
            "retrieve_pruned\n"
            "cb, st = cluster_bank(b, bn=128)\n"
            "x = torch.nn.functional.normalize(torch.randn(4, 3), dim=1)\n"
            "assert retrieve_pruned(q, x, cb, st, bm=16, bn=128).shape == (4, 128)\n"
            "assert retrieve_hybrid(q, x, cb, st, bm=16, bn=128).shape == (4, 128)\n"
            "assert rh.retrieve_hier(q, x, hb, k_tiles=2, bm=128).shape == (4, 128)\n"
            "sl = rh.build_hier_bank(b, bn=128, gsz_sem=16, gsz_geo=16, lr_rank=128, "
            "res_rank=128, topk_gsz=8, topk_lr=32, sel_lr=32)\n"
            "assert rh.hier_topk(q, None, sl, k_tiles=2, bm=128).shape == (4,)\n"
            "assert rh.retrieve_hier(q, x, sl, k_tiles=2, k_geo=2, bm=128).shape == (4, 128)\n"
            "assert rh.retrieve_hier(q, x, sl, k_tiles=2, k_geo=2, bm=128, dedup=2, "
            "adaptive_frac=0.5).shape == (4, 128)\n"
            "m = tr.SatClipModel(tr.SatClipConfig(vision=StdResNetConfig("
            "layers=(1, 1, 1, 1), width=8, in_channels=4, output_dim=16), "
            "location=SatClipLocationConfig(embed_dim=16, legendre_polys=4, "
            "capacity=32)), device='cpu')\n"
            "step = tr.make_train_step(m, tr.make_optimizer(1e-3), accum_steps=2)\n"
            "loss = step({'image': torch.randn(4, 4, 32, 32), "
            "'point': torch.zeros(4, 2)}, torch.Generator().manual_seed(0))\n"
            "assert torch.isfinite(loss)\n"
            "print('jax' in sys.modules)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
