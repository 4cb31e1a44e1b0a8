"""Utilities of the port: device rules, host z-score, saver, stage timer."""
