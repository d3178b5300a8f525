"""Pure-Python helpers of the generators: the framed-snappy codec and the
YAML writer and reader."""
