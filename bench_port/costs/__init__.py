"""Operations and bytes of the benchmark's work, counted from shapes."""
