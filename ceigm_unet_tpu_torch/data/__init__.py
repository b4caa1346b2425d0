"""Dataset readers for the Synapse and ACDC splits."""
