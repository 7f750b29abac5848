"""Launchers: the serving and training drivers (one device; the dry-run
driver comes with the LM sharding rules)."""
