from .dit import CogVideoDiT, rope_3d_tables, rope_head_perm, rope_tables
