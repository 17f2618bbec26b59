"""Launch layer of the port: the serving entry point (``launch/serve.py``).
The reference's mesh, sharding and dry-run modules are ROADMAP M11."""
