"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM (Criteo 1TB), 26 sparse + 13
dense features, dim-128 tables, bot 13-512-256-128, top 1024-1024-512-256-1,
dot interaction (``repro/configs/dlrm_mlperf.py``)."""
from ..models.recsys.dlrm import CRITEO_TABLE_SIZES, DLRMConfig
from .base import RECSYS_SHAPES, ArchSpec


def config() -> DLRMConfig:
    return DLRMConfig(n_dense=13, embed_dim=128,
                      table_sizes=CRITEO_TABLE_SIZES,
                      bot_mlp=(512, 256, 128),
                      top_mlp=(1024, 1024, 512, 256, 1), hot=1)


def reduced() -> DLRMConfig:
    return DLRMConfig(n_dense=13, embed_dim=16,
                      table_sizes=(64, 32, 100, 16, 48, 8),
                      bot_mlp=(32, 16), top_mlp=(64, 32, 1),
                      hot=(2, 1, 1, 3, 1, 1))


SPEC = ArchSpec("dlrm-mlperf", "recsys", "arXiv:1906.00091; paper", config,
                reduced, RECSYS_SHAPES,
                notes="row-sharded tables + psum_scatter embedding exchange; "
                      "Sylvie Low-bit Module optionally quantizes the exchange")
