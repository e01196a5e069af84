"""Model code of the port: params, blocks, attention, forward."""
