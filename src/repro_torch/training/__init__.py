"""Training-side modules of the port.  This slice has only the checkpoint
reader (for the weight bridge); the trainer comes with a later slice."""
