"""The trainer across GPUs: the mesh (``mesh.py``) and tensor parallelism
on local shards (``tensor_parallel.py``). The placement of the decoder's
leaves is ``models/qwen.py shard_model``."""
