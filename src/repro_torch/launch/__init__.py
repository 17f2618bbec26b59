"""Launch layer of the port: the serving and training entry points
(``launch/serve.py``, ``launch/train.py``).
The reference's mesh, sharding and dry-run modules are ROADMAP M11."""
