"""Launchers: the serving driver (the training and dry-run drivers come with
the LM stack's training half)."""
