"""Host substrate and CP-ALS driver of the port (mirrors `repro.core`)."""
