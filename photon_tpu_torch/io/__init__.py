"""I/O: the Avro codec, the Photon-ML schemas, the Avro data reader and
model persistence, in the reference's on-disk formats.

Counterpart of photon_tpu/io; files written by either package read in the
other.
"""
