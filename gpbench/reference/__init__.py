"""Plain references, one per model family: torch operations on the
benchmark's own inputs, in float64 (or in the control's precision). They
import nothing of the program under test."""
