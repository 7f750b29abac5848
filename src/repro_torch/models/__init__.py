"""The LM stack's models (serving half): layers, attention, MoE, SSM and the
unified transformer; the port of `repro.models`."""
