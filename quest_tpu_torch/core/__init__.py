"""Host-side matrices, plane packing, the gate engine and gate fusion."""
