"""Work counts and the card's peaks: the yardstick of the roofline and
MFU metrics."""
