"""Box, anchor, NMS and ROIAlign ops of the port."""
