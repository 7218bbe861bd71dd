"""Operations, bytes and roofline times of the benchmark's steps and
kernels, counted from shapes (``model``, ``kernels``) and priced at the
published peaks of the card (``peaks``). A roofline time is the larger of
the operations over the peak rate and the bytes over the memory rate;
every input byte is counted once, every output byte once."""
