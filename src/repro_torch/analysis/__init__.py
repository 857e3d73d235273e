"""Static cost analysis of the port: operation, byte, memory and
collective counts taken at the dispatcher (``cost``) and the three-term
roofline built from them (``roofline``)."""
