"""The v1 `.dt` codec: LEB128 varints, CRC-32C, LZ4 blocks, the reader
(`decode.py`) and the writer (`encode.py`). Copies of the JAX package's
`encoding/`, so each package reads the files the other writes."""
