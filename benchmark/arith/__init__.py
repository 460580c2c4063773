"""The yardstick's arithmetic: peaks and bounds, kernel operations and
bytes, the device timeline of a trace, and the model FLOPs a served
caption needs.  Plain Python and PyTorch shapes; nothing of the port."""
