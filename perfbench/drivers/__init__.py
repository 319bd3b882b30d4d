"""Traffic generators, one module per ``driver`` a traffic file names."""
