#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dspfun_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. the card: CUDA must be available (nothing runs on the CPU); prints the
   card's name and power limit, and the float32 matmul settings (no TF32);
2. build: compiles ``dspfun_tpu_torch/csrc/*.cu`` with nvcc (one process
   per source, in parallel) and prints the build time;
3. kernels: ptxas's registers and spills for each kernel of
   ``int8mm.cu`` and ``block_filter.cu`` (the build runs ``-Xptxas -v``)
   and, where ``cuobjdump`` is found, the tensor-core MMA instructions in
   each one's SASS (``IGMMA`` for the int8 kernels, ``HGMMA`` for the
   block filter's TF32 products; none is a failure);
   each int8 digit kernel (left/right layout, 3/4 digits) at the 4K
   chain's four contraction shapes and one ragged shape, the right
   3-digit kernel at motion's two i8-kron shapes, and (at the start of
   phase 8) the left and right 3-digit kernels at the spec CLI's two
   unpruned shapes, held bit-equal
   (``torch.equal``) to its plain PyTorch version on the same inputs,
   with both times (CUDA events, median of 10), its bound (operations at
   1,979 int8 TOP/s or bytes at 3.35 TB/s, the larger) and share of it,
   and its library yardstick: ``torch._int_mm``, one call per digit group
   on the K-concatenated digit planes, summed, whose int32 groups combined
   as the kernel combines must equal the plain version bit for bit
   ("refused" with the message where ``_int_mm`` refuses a shape); the
   fused block filter kernel (split TF32 on the tensor cores, a 2-CTA
   cluster per 64 rows) at motion's
   1080p chroma shape, a half-thresholded 1080p luma 8^3 shape and a
   ragged quant + threshold shape, held to 1e-2 (pels) against its plain
   version (blocks with a coefficient within the estimated kernel-vs-plain
   error ``block_filter.boundary_band`` of a threshold or quant boundary
   are excluded and counted) and, on the linear chroma shape, against a
   scipy float64 oracle beside the plain version's error, with its bound
   (the split's three TF32 products at 495 TFLOP/s), the float32 FMA
   bound of the unsplit products (67 TFLOP/s) printed beside it, and two float32
   ``torch.matmul`` calls as its library yardstick;
4. main path 1: ``filter_plans`` + ``fused_filter_2d`` on a 2160x3840x3 image
   at ``i8@1e-5`` (bench.py's configuration) and at deep ``i8``, each held
   to <= 1e-5 max abs error against a scipy float64 oracle and bit-equal
   to the same chain with the plain version forced, then
   ``spec_forward`` -> ``spec_inverse`` at the default policy (hilo,
   which is exact at this size: ``-t copy`` <= 1e-5 round trip, ``-t
   flat`` within its float32 floor) and ``-t flat`` at ``i8@1e-5``
   (kernel == plain).
   Kernel launches are counted over this phase alone: each chain must
   launch exactly 2 left and 2 right kernels, and every kernel must run;
5. timing: the 4K chain in MP/s with the kernels and with the plain
   version forced, then a torch.profiler window over five chains: device
   time per chain in the int8 kernel, its staging pass and the other
   kernels, and the device's idle share;
6. main path 2, motion: the motion CLI (``dspfun_tpu_torch.tools.motion``,
   ``-b 16x16x16 -p 0x0x0-8x8x4 -B 1.25``) on a seeded 1920x1080 yuv420p
   y4m clip of 48 frames (3 slabs).  Launches are counted over this run
   alone: 2 right 3-digit kernels (luma i8-kron) and 2 block filter
   kernels (chroma) per slab.  Every output pel must lie within one
   level of a scipy float64 blockwise DCT oracle.  Then the slab time per
   plane, the CLI's frames/s with the kernels and with both plain
   versions forced, and the per-slab luma time at slab batch 1, 2, 4;
7. main path 3, the calibration of the in-kernel digit split: ptxas's
   registers and spills and the ``IGMMA`` count of each instance of
   ``int8split.cu`` (none is a failure), then the four probes of
   ``dspfun_tpu_torch.benchmarks.calib_r3e`` and the tile sweep of
   ``calib_r3f`` at K=3840 M=960 R=6480 on that kernel.  Launches are
   counted over this phase alone: every instance must run, and the left
   3-digit int8 kernel through calib_r3f's split + int8mm route.  Each
   probe equals its plain version bit for bit; at the 4K shape every tile
   equals the plain version and the split-then-int8mm route bit for bit,
   and each route's error against a float64 product on the card is
   <= 1e-5 of the largest output.  Prints each route's time and
   eff-TOPS, the probes' kernel and plain times, and each instance's
   bound; the fused kernel's library yardstick is ``torch._int_mm`` on
   the digits split beforehand;
8. main path 4, ``spec`` then ``ispec`` through files: a seeded 3840x2160
   RGB image (noise on a smooth term) written by the port's
   ``write_image`` as a 16-bit PNG, then ``tools.spec.main`` and
   ``tools.ispec.main`` in process for ``-t flat`` and ``-t copy`` at the
   tools' default policy (no kernel may launch) and ``-t flat`` at
   ``i8@1e-5`` (launches counted over each call: one left and one right
   3-digit kernel per tool; both files byte-equal to the same run with
   the plain version forced).  Each spectrum file is held to a scipy
   float64 oracle of the reference's scalar chain quantised to 16 bits
   (within one level; prints the share off by one) and its ``DC``
   property to the channel means (1e-6).  ``-t flat`` must return the
   input within the noise its 16-bit spectrum leaves: every coefficient
   is stored to half a level of ``(f / 2 + 0.5) * 254 / 255``, the
   inverse sums w*h of those errors with unit weights, so the image
   comes back with sqrt(w*h) * 2 * 255/254 / sqrt(12) = 1669.3 levels rms
   of noise at this size (held to 5 % of that, the largest to 7 sigma =
   11685 levels).  ``-t copy`` stores no sign, a PNG holds no negative
   coefficient, and the writer's clip drops them (in the JAX package
   too): its output is held to a float64 inverse of the spectrum as the
   file holds it, within one level.  Prints each tool's seconds per stage
   (read, host to device, compute on the host's clock and between CUDA
   events, device to host, quantise + PNG encode + write), the peak
   device memory of the default-policy run, a float64 contraction rounded
   to float32 beside the ``exact`` contraction at spec's two shapes (time
   and distance in float32 ulps), and, for the PNG codec, a round trip of
   each of the five filters at both depths at a small size and the
   encode and decode seconds of a 3840x2160 8-bit RGB image per filter;
9. main path 5, ``scan``: ``tools.scan.main`` in process on a seeded
   256x256 8-bit RGB PNG (BASELINE.md item 4) with ``-m zigzag -P``,
   every scan index, to y4m at ``-S 16`` (4096 frames, packed to yuv444p
   on the card) and to fvid at ``-S 64`` (1024 frames; the 65,536 frames
   of ``-S 1`` are 12.9 GB of y4m).  The last frame and three in between
   are held to a float64 oracle (scipy's DCT of the float32 pixels, the
   same schedule, synthesised in ``torch.float64`` on the card): one
   8-bit level for y4m, 1e-5 for fvid; the ``-P`` index to the oracle's
   on every frame the oracle decides further than 1e-5 from a rounding
   boundary.  The default policy may launch no kernel.  Then the y4m run
   at ``i8@1e-5``: the left 3-digit kernel launches twice in the forward
   DCT and twice per 64-frame chunk (both contractions of the dense
   branch are middle axes and go left), and the file equals the one of a
   run with the plain version forced, byte for byte; the kernel at the
   chunk's shape (M=K=256, R=49,152) against its plain version.  Then a
   1920x1080 image, ``-S 4 -n 128`` to y4m with ``-p false`` and with ``-p
   true`` (the chunk times of dense against pruned, CUDA events) and
   ``-n 16`` to fvid (both within 1e-5 of the oracle and of each other).
   Then ``-v -s -i``: the four panes against a host float64 oracle, one
   level.  Prints frames/s and the seconds per stage of every run;
10. main path 6, ``zoom``: the 4-digit kernels against their plain
   versions at the still's shapes (left4 M=4320 K=1080 B=3 R=1920, right4
   M=7680 K=1920 R=12,960) and at the two pans' (left4 M=K=1080 B=3
   R=1920 and right4 M=K=1920 R=3240; left3 M=K=768 B=3 R=1024 and right3
   M=K=1024 R=2304), then ``tools.zoom.main`` in process on a seeded
   1920x1080 8-bit RGB PNG.  The oracle's bases, DCT-III matrix and
   zigzag walk are closed forms written here, not the package's.  (a) ``-s 4 -g`` (BASELINE.md item 2) at
   the tool's default policy, deep ``i8``, to fvid and to y4m: launches
   left4 3 (the forward DCT's two and the frame's one) and right4 1; the
   fvid frame within 1e-5, after the OETF, of a float64 synthesis from
   a float64 basis, both computed on the card; byte-equal to a run with
   the plain version forced; the y4m frames (packed on the card, and with
   the packer off) within one level; seconds per stage and the peak
   device memory.  (b) the pan ``-s 4 -v 1920x1080 -n 24 -x 'i/n*(w*xs-vw)'
   -y '(h*ys-vh)/2'`` to y4m: the route of every frame (the device basis
   or the planned host basis), frames/s, seconds per stage, three frames
   against the oracle (one level), one left4 and one right4 per planned
   frame, the file byte-equal to a run with the plain version forced.  (c) a 2x pan of a 1024x768 image in a 1024x768 view, where
   ``device_basis_accurate`` holds on all 12 frames, to fvid: at the
   default policy (float32 products, no launch in the synthesis) and at
   ``i8@1e-5`` (``i8_contract_rt``: one left3 and one right3 per frame);
   each prints PASS or MISS against 1e-5 of the oracle.  The first must
   pass.  The second misses (both operands of both contractions are
   split into 3 digits at run time): its file must equal the one of a
   run with the plain version forced, byte for byte, and its error stay
   within six standard deviations of the split's rounding model,
   computed from the run's spectrum.  (d) ``--showsamples=grid``, ``--basis
   native`` and ``--basis centered`` at 320x240 against the oracle;
11. main path 7, the basis tools in process on a seeded 128x128 8-bit RGB
   PNG.  The values each applybasis run computes (complex64 at the
   default policy) are held to 1e-5 of their largest |value| against a
   float64 oracle on the card whose bases are closed-form cosines and
   exponentials written here, and each PNG to one level of the same run
   at ``f64`` (the share off by one printed).  (a) ``-f DCT2 -u 16x16``
   (values [128, 128, 16, 16, 3], a 2177x2177 RGBA frame); (b)
   ``-fDCT2 -u 128x128 -d full.coeff``, then ``-f DCT3 -I`` from the dump
   at ``-u 128x128`` (the full reconstruction, within one level of the
   input; its max and rms distance printed) and at ``-u 16x16`` (each
   tile one coefficient block's contribution); (c) ``-f DFT -P magnitude
   -R linearlog -N hue -g --bg '#204080' -u 8x8`` on a 128x128 crop; (d)
   ``genbasis --function DFT --size 64x64 --natural --plane complex``
   (host float64: default and f64 files byte-equal); (e) ``draw -b
   3840x2160 -f 3x3:0.4 -f 2x5:0.2 -f 4x6:0.2`` at the default policy (no
   launch) and at ``i8@1e-5`` (the counts set to 0 before the run: left3 1
   along H, right3 1 along W, where the [H, W, 1] grid's one column takes
   the right form), the canvas within 1e-5 of a float64 DCT-III, the file
   byte-equal to a run with the plain version forced; then the 3-digit
   kernels against their plain versions at draw's shapes, the batched
   left form with one column (R=1) beside the right form, and the two
   forms of the W contraction bit-equal with their times.  Prints seconds
   by stage and the peak device memory of every run;
12. main path 8, ``rotate`` and ``transcode`` (host work) on the first 8
   frames of phase 6's 1920x1080 yuv420p clip:
   ``rotate y-xz`` (90 degrees ccw) and ``rotate zyx`` (1920 frames of
   8x1080) to y4m, every pel equal to a
   numpy index-map oracle of the reference's loop (rotate.c:159-172) on
   the decoded clip; ``transcode`` y4m -> fvid -> y4m, byte-equal to the
   clip.  Prints the seconds of each;
13. main path 9, motion's ``--eval``, FFV1-in-NUT and Matroska, and
   ``--resume-file`` on phase 6's clip.  (a) The README's fade, ``-b
   0x0x0 --eval 'c * ((width-x)/width) * ((height-y)/height) *
   ((depth-z)/depth)'`` (one 1920x1080x48 block and two 960x540x48
   blocks) to ``.nut`` at the default policy and at ``i8@1e-5``: every
   pel within one level of a float64 scipy oracle (DCT-II, the weights,
   DCT-III, rounding), the share off by one printed and under 0.1 % at
   the default policy; at ``i8@1e-5`` left3 and right3 launch (counted
   over that run), the file equals a plain-forced run's byte for byte,
   and the kernels are held to their plain versions at the shapes the
   run gave them; wall, stages, device busy time (torch.profiler) and
   peak device memory of each run.  (b) ``--eval 'c*(1+0.1*random(0))'``
   on a 64x48x4 crop with ``-b 8x8x2`` on the card and with ``--device
   cpu``: equal slots and generator state after the run, frames within
   one level, the host round trip's share of the wall.  (c) phase 6's
   lowpass to ``.nut`` and ``.mkv`` (FFV1): both decode to the y4m run's
   frames, kernel #3 launches, the chroma takes ``cuda-kron``; the write
   stage against y4m's, and the read through ``NativeBackedReader``
   against the Python reader's.  (d) ``--resume-file``: the lowpass to
   ``.nut`` cut after one slab and finished by a rerun with the same
   flags, equal to the uninterrupted run's frames;
14. main path 10, the device mesh (``dspfun_tpu_torch/parallel``), kept
   under 120 s.  (d) Each kernel against its plain version at one rank's
   shard shape at two ranks (spec's W and H contractions, motion's luma
   pair, zoom's 4-digit pair, the block filter at NB=4020), with times,
   bounds and library yardsticks.  (a) Ranks that share the card over
   gloo (``RankPool(["cuda:0"] * n, "gloo")``, spawned after the build),
   2 and then 4 of them, each driving at full width: ``spec -t flat``
   forward and inverse of 3840x2160 RGB at ``i8@1e-5`` (and, on 2 ranks,
   at the default policy) over 'space'; motion's volume route (``-b 0x0x0``, a
   lowpass box boosted, the rest damped, the DC kept) on phase 6's 1080p
   4:2:0 clip over 'space' (2 ranks) and space=2,time=2 (4); motion's
   block route (phase 6's lowpass) over 'space'; scan's 256x256 zigzag
   ``-S 16`` (128 frames) at ``i8@1e-5``; zoom's 4x ``-g`` still of 1080p
   at deep ``i8``.  Each runs twice (the first builds plans) and the
   second is measured with the counts at 0 (kernel launches summed over
   the ranks and returned to the parent; collectives synchronised so
   their seconds are their own): seconds by stage, the collectives'
   share of the wall, peak device memory per rank; then every rank
   gathers and rank 0 holds the output to the single-device port on the
   card (timed) with the JAX package's own mesh tolerances: the block
   route bit-equal, spec 3e-5 forward and 1e-4 inverse (DC 1e-6), scan
   1e-4 with equal parity, zoom 2e-5, the volume 1e-5 of the pel range.
   (b) Every case once more over nccl at world size 1 on small inputs,
   once each (each collective valid for NCCL; no times).  (c) With one card, ``motion --mesh
   2`` and ``spec -M 2`` exit 1 (a mesh takes a card per rank); with more,
   both run over nccl and equal one card's output.  Every kernel of the
   path must launch on some rank;
15. main path 11, the ffmpeg bridge, ``ffplay:``, BMP and sixel, on shim
   binaries (``tests/torch_ffmpeg_shims.py``: the card's machine has no
   ffmpeg) put first on PATH for the phase alone.  (a) Phase 6's
   lowpass on the first 8 frames of its clip, from ``in.mp4`` (the y4m
   behind the shim's ``FAKEMP4`` header) to ``out.mp4``: equal byte for
   byte to the same run from the y4m clip to y4m, launches of kernels #2
   and #3 counted, the kernels held to their plain versions at the run's
   shapes; again at 10 bits (a ``yuv420p10le`` probe: ``RawReader`` in,
   ``RawWriter`` out), the payload equal to the 10-bit y4m run's; the
   seconds of the probe, the pump in (read), compute and the pump out
   (write), and the MB/s through the pipes.  (b) An ``ffplay:`` sink of
   one 1920x1080 frame: the color properties on its logged argv.  (c)
   ``spec -t flat`` at ``i8@1e-5`` of a 3840x2160 RGB BMP (levels at noise
   0.02): the spectrum equal to the one from the PNG of the same pixels,
   ``ispec`` of it back to BMP, kernels #1-#2 launched (counted on the BMP runs)
   and held to their plain versions at spec's shapes; the BMP's decode
   seconds.  (d) ``ispec`` to ``sixel:`` at 640x360: the file equal to
   ``encode_sixel`` of the levels the same run writes to PPM, and
   ``encode_sixel`` of the phase's source levels equal to the JAX
   encoder's bytes (``SIXEL_DIGEST``, pinned by
   tests/test_torch_sixel.py: Pillow's median cut, ``io/quant.py``), and
   the encode seconds;
16. main path 12, JPEG in and out through the port's own codec
   (``io/jpeg.py``, ``native/jpeg.cpp``, built with g++ at first use).
   (a) The seeded 3840x2160 and 517x333 RGB images encoded and decoded:
   the file's and the decoded pixels' sha256 equal Pillow's
   (``JPEG_DIGESTS``, pinned by tests/test_torch_jpeg.py), so this host's
   ``-march=native`` build gives the bytes of any other; encode and
   decode seconds and MB/s.  (b) ``spec -t flat -G 1000`` of the 4K
   JPEG at ``i8@1e-5``: the spectrum equal to the one from a PNG of the
   JPEG's decoded pixels, kernels #1-#2 once a tool; ``ispec`` of it back
   to ``.jpg``.  (c) motion's lowpass (phase 6's argv) on 8 1080p frames
   (``JPEG_FRAMES``) written as ``in%04d.jpg``, to y4m, equal byte for
   byte to the same run on a PPM sequence of the decoded frames, with the
   same launches of kernels #2 and #3 (at least one); seconds by stage
   (read is the decode).  The int8
   kernels are held to their plain versions at every shape the phase
   gave them;
17. main path 13, progressive JPEG and compressed TIFF through the port's
   own codecs (``io/jpeg.py`` on ``native/jpeg.cpp``, ``io/imgcodecs.py``
   on ``native/tiff.cpp`` and zlib).  (a) The fixtures of
   ``tests/goldens/`` (``CODEC_FIXTURES``: Pillow's 3840x2160 progressive
   JPEG, a gray and a 4:4:4 restart-marked 517x333 one, LZW TIFFs at
   predictor 1 and 2, a PackBits TIFF and an associated-alpha RGBA LZW
   TIFF, written by tests/torch_codec_fixtures.py) each decoded by the
   codec ``read_image`` picks for it, file and pixels equal to Pillow's
   sha256 (pinned by tests/test_torch_jpeg.py); the 4K progressive
   decode equal to the port's decode of its own baseline encode of the
   same levels; 3840x2160 deflate TIFFs at predictor 1 and 2, written
   with zlib by ``tests/torch_codec_fixtures.py:make_tiff``, decoded to
   their levels; seconds and MB/s of RGB of
   each decode.  (b) ``spec -t flat -G 1000`` of the 4K progressive JPEG
   and of the predictor-2 deflate TIFF at ``i8@1e-5``: the spectrum
   equal to the one from a PNG of the decoded pixels, kernels #1-#2 once
   a tool; ``ispec`` at ``i8@1e-5`` back to TIFF (phase 16 holds ispec
   to a 4K JPEG).  (c)
   motion's lowpass (phase 6's argv) on 8 1080p frames (``CODEC_FRAMES``)
   written as deflate ``frame%04d.tif`` (predictor 1 and 2 in turn),
   equal byte for byte to the same run on a PPM sequence of the same
   levels, with the
   same launches of kernel #2 (at least one).  The int8 kernels are held
   to their plain versions at every shape the phase gave them;
18. main path 14, GIF through the port's own codec (``io/gif.py`` on
   ``native/gif.cpp``, ``io/quant.py`` on ``native/quant.cpp``).  (a) The
   GIF fixtures of ``tests/goldens/`` (``GIF_FIXTURES``: Pillow's
   interlaced RGB, RGBA with a transparency index and gray files, and
   hand-written files with a local palette at an offset, a 4-colour
   palette at code size 2 and a deferred clear) decoded, file and RGBA
   pixels equal to Pillow's sha256 (pinned by tests/test_torch_gif.py);
   the 3840x2160 levels of ``CODEC_4K`` encoded to Pillow's bytes
   (``GIF_DIGESTS``) and decoded; seconds of the quantiser, of the LZW
   coding and container, and of the decode.  (b) ``spec -t flat -G
   1000`` of that GIF at ``i8@1e-5``: the spectrum equal to the one from
   a PNG of the decoded pixels, kernels #1-#2 once a tool; ``ispec`` at
   ``i8@1e-5`` to ``.gif`` equal to ``encode_gif`` of the levels the
   same ispec writes to PPM.  (c) motion's lowpass (phase 6's argv) on
   8 1080p frames (``GIF_FRAMES``) written as ``in%04d.gif``, to y4m,
   equal byte for byte to the same run on a PPM sequence of the decoded
   frames, with the same launches of kernel #2 (at least one); seconds
   by stage.  The int8 kernels are held to
   their plain versions at every shape the phase gave them;
19. main path 15, TIFF layouts and sample formats, and CMYK JPEG, through
   the port's own codecs (``io/imgcodecs.py``, ``io/jpeg.py`` on
   ``native/jpeg.cpp``).  (a) Small TIFFs written by hand at run time
   (``tests/torch_codec_fixtures.py:layout_tiffs``, no Pillow: tiles with
   predictor 2, planar 16-bit RGBA, FillOrder 2, predictor 3 on float
   samples, CMYK and 16-bit CMYK, I;32S, a 4-bit palette, PA,
   Orientation 6 and 8) read to Pillow's pixels (``LAYOUT_TIFF_DIGESTS``);
   the CMYK JPEG fixtures of ``tests/goldens/`` (``CMYK_FIXTURES``: the
   4K progressive file, a baseline one with restart markers, it as YCCK
   and without its Adobe marker) decoded, file and pixels equal to
   Pillow's sha256; a 3840x2160 tiled (256x256) deflate CMYK TIFF with
   predictor 2 and a 3840x2160 I;32S TIFF past 0 and 65535 written and
   decoded to Pillow's digests (``TIFF_4K_DIGESTS``; all pinned by
   tests/test_torch_tiff.py and test_torch_jpeg.py); seconds of each
   write and decode.  (b) ``spec -t flat -G 1000`` of the three 4K files
   at ``i8@1e-5``: the spectrum equal to the one from the same pixels as
   a 16-bit PNG (the I;32S file, whose pixels run past [0, 1], against
   its float pixels handed to the tool), kernels #1-#2 once a tool.  (c)
   motion's lowpass (phase 6's argv) on 8 1080p
   frames (``TIFF_CMYK_FRAMES``) written as ``in%04d.tif`` (tiled,
   planar, deflate CMYK, Orientation 1), to y4m, equal byte for byte to
   the same run on a PPM sequence of the decoded frames, with the same
   launches of kernel #2 (at least one); seconds by stage.  The
   int8 kernels are held to their plain versions at every shape the
   phase gave them;
20. main path 16, JPEG-in-TIFF, YCbCr, CCITT fax and CIELab TIFF,
   through the port's own codecs (``io/imgcodecs.py``, ``io/jpeg.py``,
   ``native/fax.cpp``, ``native/tiff.cpp``).  (a) Small TIFFs written by hand at run time
   (``tests/torch_codec_fixtures.py:more_tiffs``, no Pillow: a tiled
   4:2:0 JPEG-in-TIFF of ``encode_jpeg``'s streams, YCbCr LZW at 2x2 and
   4x2 with a ReferenceBlackWhite, G3 1-D, G3 2-D with EOL fill bits, G4
   in FillOrder 2, CCITT RLE, CIELab deflate chunky and planar) and
   Pillow's JPEG-in-TIFF goldens of
   ``tests/goldens/`` (YCbCr at 1x1 in 8-row strips, RGB, gray, CMYK) read
   to Pillow's pixels (``MORE_TIFF_DIGESTS``, ``TIFF_JPEG_FIXTURES``);
   (b) a 3840x2160 tiled (256x256) 4:2:0 JPEG-in-TIFF, a 3840x2160 G4
   document page and a 3840x2160 YCbCr 2x2 deflate TIFF written and
   decoded to Pillow's digests (``TIFF_MORE_4K_DIGESTS``; all pinned by
   tests/test_torch_tiff_more.py), seconds and MB/s of each; (c) ``spec
   -t flat -G 1000`` of the JPEG-in-TIFF and the G4 page at ``i8@1e-5``,
   each spectrum equal to the one from the same pixels as a 16-bit PNG,
   kernels #1-#2 once a tool;
   (d) motion's lowpass on 8 1080p frames written as ``in%04d.tif``
   (4:2:0 JPEG-in-TIFF in 16-row strips) to y4m, equal byte for byte to
   the same run on a PPM sequence of the decoded frames, with the same
   launches of kernel #2 (at least one); seconds by stage.  The int8
   kernels are held to their plain versions at every shape the phase gave
   them;
21. main path 17, WebP through the port's own decoder (``io/webp.py``,
   ``native/webp.cpp``).  (a) The WebP fixtures of ``tests/goldens/``
   (``WEBP_FIXTURES``: Pillow's lossy files at quality 80 and 100, RGBA
   lossy with its ALPH chunk, lossless RGB, RGBA and a 16-colour palette,
   a two-frame animation, a VP8X file written by hand with a raw
   gradient-filtered ALPH chunk and metadata chunks, the 4K file and the 8
   1080p frames of (c)) each read through ``images._decoder`` to the
   port's decoder, file and RGBA pixels equal to the JAX package's sha256
   (pinned by tests/test_torch_webp.py).  (b) ``codec_webp_4k.webp``
   (Pillow's quality 80 of phase 17's 4K levels) decoded, the best of
   ``WEBP_REPEATS`` in seconds and MB/s; ``spec -t flat -G 1000`` of it at
   ``i8@1e-5``, the spectrum equal to the one from the same pixels as a
   PNG, kernels #1-#2 once a tool.  (c) motion's
   lowpass (phase 6's argv) on the 8 1080p WebP frames to y4m, equal byte
   for byte to the same run on a PPM sequence of their decoded frames,
   with the same launches of kernel #2 (at least one); seconds by stage.
   The int8 kernels are held to their plain versions at every shape the
   phase gave them;
22. main path 18, TGA, PCX, SGI, QOI, IM, ICO and DIB through the port's
   own codecs (``io/rawimg.py``, ``io/ico.py``, ``io/imgcodecs.py`` on
   ``native/rawimg.cpp``).  (a) The fixtures of ``tests/goldens/``
   (``OTHER_FIXTURES``: Pillow's files and, for the kinds Pillow does not
   write, files made by ``tests/torch_codec_fixtures.py``: RLE, top-down,
   flipped, 16-bit and colour-mapped TGA, 2- and 4-plane PCX, RLE SGI at 1
   and 2 bytes a sample) each read through ``images._decoder`` to its
   format's decoder, file and RGBA pixels equal to the JAX package's
   sha256 (pinned by tests/test_torch_other_formats.py).  (b) A 3840x2160
   QOI (the port's encoder) and RLE TGA (the fixtures module's maker) of
   ``_seeded_pixels`` seed 43 at noise 0.02 decoded, the best of
   ``OTHER_REPEATS`` in seconds and MB/s;
   ``spec -t flat -G 1000`` of each at ``i8@1e-5``, each spectrum equal
   to the one from the same levels as a PNG, kernels #1-#2 once a tool;
   ``ispec`` at ``i8@1e-5`` to PPM and to each of ``OTHER_ISPEC`` (TGA,
   ICO), each file equal to the port's encoder of the PPM's pixels; and
   ``write_image``'s encoder of each of ``OTHER_EXTS`` on the seeded
   levels, timed, equal to the JAX package's (Pillow's) sha256.  (c) motion's lowpass
   (phase 6's argv) on 8 1080p RLE TGA frames to y4m, equal byte for byte
   to the same run on a PPM sequence of the decoded frames, with the same
   launches of kernel #2 (at least one); seconds by stage.  The int8
   kernels are held to their plain versions at every shape the phase gave
   them;
23. main path 19, Zstandard and LZMA TIFF, and libtiff's old LSB-first
   LZW, through the port's own codecs (``io/imgcodecs.py`` on
   ``native/zstd.cpp``, the standard library's lzma and
   ``native/tiff.cpp``).  (a) The fixtures of ``tests/goldens/``
   (``ZSTD_LZMA_FIXTURES``: Pillow's Zstandard and LZMA files in L, RGB,
   RGBA, I;16 and F with predictor 3, tiled and planar files with
   predictor 2 written by ``tests/torch_codec_fixtures.py`` through
   zstandard and lzma, and the two 3840x20 strip donors of (b)) and the
   LSB-first LZW files the fixtures module writes at run time
   (``OLD_LZW_DIGESTS``), each read through ``images._decoder`` to
   ``decode_tiff``, file and RGBA pixels equal to the JAX package's
   sha256 (pinned by tests/test_torch_tiff_zstd_lzma.py).  (b) The
   3840x2160 Zstandard and LZMA TIFFs with predictor 2 that
   ``strip_4k`` assembles of the donors' Pillow-compressed strips, each
   decoded (best of ``ZSTD_LZMA_REPEATS``, seconds and MB/s) to Pillow's
   digest (``STRIP_4K_DIGEST``); ``spec -t flat -G 1000`` of the
   Zstandard file at ``i8@1e-5``, the spectrum equal to the one from
   the same levels as a PNG, kernels #1-#2 once.  (c) motion's lowpass
   (phase 6's argv) on 8 1080p frames written as LZMA and Zstandard TIFF
   in turn, to y4m,
   equal byte for byte to the same run on a PPM sequence of the decoded
   frames, with the same launches of kernel #2 (at least one); seconds by
   stage.  The int8 kernels are held to their plain versions at every
   shape the phase gave them;
24. main path 20, progressive JPEG left short (smoothed as libjpeg-turbo
   smooths it) and 8-bit lossless JPEG, through the port's own codec
   (``io/jpeg.py`` on ``native/jpeg.cpp``).  (a) The files
   ``tests/torch_codec_fixtures.py`` makes at run time (``short_jpegs``:
   Pillow's gray and 4:4:4 restart-marked goldens cut to their first scan,
   without their last or without their AC refinements; ``lossless_jpegs``:
   predictors 1-7, point transforms 1 and 2, restart intervals, a scan
   per component, 4:2:0 sampling, CMYK) each read through
   ``images._decoder`` to ``decode_jpeg``, file and pixels equal to
   Pillow's sha256 (``SHORT_JPEG_DIGESTS``, ``LOSSLESS_DIGESTS``; pinned by
   tests/test_torch_jpeg_lossless.py).  (b) ``codec_prog_4k.jpg``'s DC
   scans alone and all its scans but the last, each decoded (best of
   ``SHORT_REPEATS``, seconds and MB/s) to Pillow's digest; ``spec -t flat
   -G 1000`` of the second at ``i8@1e-5``, the spectrum equal to the one
   from the same pixels as a PNG, kernels #1-#2 once.  (c) A 3840x2160
   lossless JPEG of
   ``CODEC_4K``'s levels (predictor 1, a restart interval every 16 rows)
   written by the fixtures module's numpy writer and decoded to those
   levels exactly, seconds and MB/s.  The int8 kernels are held to their
   plain versions at every shape the phase gave them;
25. main path 21, PSD and DDS read, DDS written, CUR, DCX and IM's float
   and YCbCr modes, through the port's own codecs (``io/psd.py``,
   ``io/dds.py`` on ``native/bcn.cpp``, ``io/ico.py``, ``io/rawimg.py``).
   (a) Every fixture of ``tests/torch_codec_fixtures.py:psd_dds_fixtures``
   (Pillow's DDS and DCX goldens; PSD, CUR, hand-made DDS and IM files
   written at run time) read through ``images._decoder`` to its decoder,
   file and pixels equal to the JAX package's sha256
   (``PSD_DDS_FIXTURES``, pinned by tests/test_torch_dds.py).  (b) A
   3840x2160 PackBits RGB PSD of ``CODEC_4K``'s levels and a DX10 BC7 DDS
   of seeded random blocks, each decoded (best of ``PSD_DDS_REPEATS``,
   seconds and MB/s) to the levels and to Pillow's digest.  (c) ``spec -t
   flat -G 1000`` of the PSD at ``i8@1e-5``, the spectrum equal to the one
   from the same levels as a PNG, kernels #1-#2 once.  (d) ``ispec`` at
   ``i8@1e-5`` to DDS and to PPM: the DDS file equals ``encode_dds`` of
   the PPM's pixels, and ``encode_dds`` of the levels Pillow's sha256.
   The int8 kernels are held to their plain versions at every shape the
   phase gave them;
26. main path 22, JPEG 2000 read by the port's own codec
   (``io/jpeg2000.py`` on ``native/j2k.cpp``).  (a) Every fixture of
   ``tests/torch_codec_fixtures.py:j2k_fixtures`` (Pillow's JP2 and raw
   codestream goldens, reversible and irreversible, tiles, RPCL with
   precincts, quality layers, 16-bit gray, gray + alpha in CPRL, and the
   sYCC, CMYK, palette and 12-bit signed edits made of them at run time)
   read through ``images._decoder`` to ``decode_j2k``, file and pixels
   equal to the JAX package's sha256 (``J2K_FIXTURES``, pinned by
   tests/test_torch_jpeg2000.py).  (b) The two 3840x2160 goldens (an
   irreversible JP2 of ``CODEC_4K``'s levels, a lossless JP2 of smooth
   ramps), each decoded (best of ``J2K_REPEATS``, seconds and MB/s) to
   Pillow's digest.  (c) ``spec -t flat -G 1000`` of the irreversible 4K
   JP2 at ``i8@1e-5``, the spectrum equal to the one from the same levels
   as a PNG, kernels #1-#2 once.  The int8 kernels are held to their
   plain versions at every shape the phase gave them;
27. main path 23, arithmetic-coded JPEG read by the port's own codec
   (``io/jpeg.py`` on ``native/jpeg.cpp:jpg_decode_arith``).  (a) Every
   golden of ``ARITH_FIXTURES`` (libjpeg's arithmetic coder wrote them:
   sequential 4:2:0 and 4:4:4 with restarts, progressive gray with DAC
   conditioning, CMYK with restarts, progressive YCCK, a short progressive
   file, and JPEG-in-TIFF tiles and strips) through ``images._decoder`` to
   ``decode_jpeg`` or ``decode_tiff``, file and pixels equal to Pillow's
   digests.  (b) One golden padded past Pillow's 65,536-byte chunk raises,
   as Pillow raises.  (c) A 3840x2160 JPEG-in-TIFF holding
   ``codec_prog_4k.jpg``'s coefficients in one SOF9 strip, decoded (best of
   ``ARITH_REPEATS``, seconds and MB/s) to that file's pixels, beside phase
   17's Huffman decode of it.  (d) ``spec -t flat -G 1000`` of the TIFF at
   ``i8@1e-5``, the spectrum equal to phase 17's of ``codec_prog_4k.jpg``,
   kernels #1-#2 once; the int8 kernels are held to their plain versions at
   every shape the phase gave them;
28. main path 24, old-style JPEG, 12-bit JPEG-in-TIFF, ThunderScan and
   RLE-W TIFF read by the port's own codecs (``io/ojpeg.py``,
   ``io/imgcodecs.py``, ``native/jpeg.cpp``, ``tiff.cpp``, ``fax.cpp``).
   (a) Every golden of ``OJPEG_FIXTURES`` (old-style JPEG in both layouts,
   4:2:0, 4:2:2 with restarts in strips, 4:4:4 with ReferenceBlackWhite,
   gray, big-endian; 12-bit SOF1 strips and SOF3 tiles; ThunderScan;
   RLE-W under FillOrder 2) through ``images._decoder`` to ``decode_tiff``,
   file and samples equal to Pillow's digests.  (b) The 3840x2160
   old-style JPEG golden (Pillow's baseline JPEG of ``codec_prog_4k.jpg``'s
   levels in 34 strips) decoded (best of ``OJPEG_REPEATS``) beside phase
   20b's 4K JPEG-in-TIFF decode.  (c) A 4K 12-bit gray JPEG-in-TIFF,
   written here, decoded (best of ``OJPEG_REPEATS``) to Pillow's digest.
   (d) ``spec -t flat -G 1000`` of the old-style JPEG at ``i8@1e-5``,
   kernels #1-#2 once, its spectrum equal to that of a PNG of the same
   decoded pixels; the int8 kernels are held to their plain versions at
   every shape the phase gave them;
29. main path 25, JPEG 2000's rest read by the port's own codec
   (``io/jpeg2000.py``, ``native/j2k.cpp``).  (a) Every golden of
   ``J2K_MORE_FIXTURES`` (Pillow's own OpenJPEG wrote them: POCs in the
   main header, in every tile and over layers; SOP and EPH markers; each
   code-block style switch alone and all six under both wavelets; RGN;
   COC and QCC in the main and tile-part headers; 4:2:0 and 4:2:2
   components, a sYCC JP2, four components with sub-sampled chroma)
   through ``images._decoder`` to ``decode_j2k``, file and pixels equal to
   the JAX package's digests.  (b) Pillow's 4096x2160 ``cinema4k-24`` file
   and a 3840x2160 file in bypass with every pass terminated, decoded (best
   of ``J2K_REPEATS``) to Pillow's digests beside phase 26b's plain 4K
   decodes.  (c) ``spec -t flat -G 1000`` of the cinema file at
   ``i8@1e-5``, kernels #1-#2 once, its spectrum equal to that of a PNG of
   the same decoded pixels; the int8 kernels are held to their plain
   versions at every shape the phase gave them;

Prints one JSON line of per-kernel results (launches on the main paths,
max abs error, ms, plain_ms, bound_ms, bound_by, library_ms), then, as
the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np

from dspfun_tpu_torch.benchmarks import cuda_ms

H, W, C = 2160, 3840, 3           # 4K RGB, bench.py's image
CHAIN_TOL = 1e-5                  # max abs error vs float64 (BASELINE.md)
SRC = "dspfun_tpu_torch/csrc/int8mm.cu"
REPLACES = {                      # the Pallas bodies each instantiation replaces
    "left3": "dspfun_tpu/ops/int8mm.py:165",
    "left4": "dspfun_tpu/ops/int8mm.py:180",
    "right3": "dspfun_tpu/ops/int8mm.py:199",
    "right4": "dspfun_tpu/ops/int8mm.py:213",
}
# the card's peaks (NVIDIA's H100 SXM data sheet: dense rates at 700 W)
INT8_OPS = 1979e12                # int8 tensor-core operations/s
F32_FLOPS = 67e12                 # float32 outside the tensor cores
TF32_FLOPS = 495e12               # TF32 tensor-core operations/s
HBM_BYTES = 3.35e12               # device memory bytes/s
BF_SRC = "dspfun_tpu_torch/csrc/block_filter.cu"
BF_REPLACES = "dspfun_tpu/ops/pallas_kernels.py:51"
BF_TOL = 1e-2                     # pels; the JAX package's bound (tests/test_pallas.py:43)
I8S_SRC = "dspfun_tpu_torch/csrc/int8split.cu"
I8S_REPLACES = {                  # the split kernel's instances and the Pallas bodies they replace
    "fixed1": "benchmarks/calib_r3e.py:40, benchmarks/calib_r3e.py:46",
    "exp1": "benchmarks/calib_r3e.py:51",
    "exp3g2": "benchmarks/calib_r3e.py:59",
    "exp3g3": "benchmarks/calib_r3f.py:19",
}
CALIB_TOL = 1e-5                  # rel error vs float64 at the 4K shape (the chain's gate)
# motion at 1080p 4:2:0 (benchmarks/suite.py:444-456 at the frame size
# users process): 16x16x16 luma blocks run i8-kron, the 8x8x16 chroma
# blocks the fused block filter
MH, MW, MFRAMES = 1080, 1920, 48
MOTION_ARGS = ["-Q", "-b", "16x16x16", "-p", "0x0x0-8x8x4", "-B", "1.25"]
MOTION_NB = (MH // 16) * (MW // 16)   # 8040 blocks per slab and plane
# the luma i8-kron contractions: [S, V] then [V, S], S = 8*8*4 pass-band rows
MOTION_I8_SHAPES = [(256, 4096, MOTION_NB, "motion fwd"), (4096, 256, MOTION_NB, "motion inv")]
# the spec and ispec CLIs at i8@1e-5 (no mask, so nothing is pruned): the
# H contraction channel-first in the left layout, then W in the right one
SPEC_I8_SHAPES = [("left", H, H, C, W, "spec H"), ("right", W, W, 1, C * H, "spec W")]
# (layout, M, K, B, R): the 4K i8 chain's contractions with the bench mask
# (cutoff 0.25 keeps 540 of 2160 rows and 960 of 3840 columns), then one
# ragged shape per layout with M, K and R off every tile multiple
KERNEL_SHAPES = [
    ("left", 540, 2160, 3, 3840, "forward H"),
    ("left", 2160, 540, 3, 960, "inverse H"),
    ("right", 960, 3840, 1, 3 * 540, "forward W"),
    ("right", 3840, 960, 1, 3 * 2160, "inverse W"),
    ("left", 77, 300, 2, 45, "ragged"),
    ("right", 77, 300, 2, 45, "ragged"),
]


# spec -t flat through a 16-bit file: levels rms of noise per sqrt(pixel)
# in the image that ispec returns (see phase 8 in the docstring)
FLAT_FILE_NOISE = 2.0 * 255.0 / 254.0 / np.sqrt(12.0)
SPEC_CLI_EXPECT = {"left3": 1, "right3": 1}     # launches per tool at i8@1e-5


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bound(ops: float, rate: float, nbytes: float) -> tuple[float, str]:
    """(the least time in ms the card could take, what bounds it): the
    larger of the operations over the peak rate and the bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _pairs(a_planes: int, x_digits: int) -> int:
    """Digit-pair products of the plain version's groups (one group per A plane)."""
    return sum(1 for g in range(a_planes) for i in range(g + 1) if g - i < x_digits)


def _i8_bound(a, x, layout: str) -> tuple[float, str]:
    nd, m, _ = a.shape
    _, b, d1, d2 = x.shape
    k, r = (d1, d2) if layout == "left" else (d2, d1)
    return _bound(2.0 * m * k * r * b * _pairs(nd, x.shape[0]), INT8_OPS,
                  a.numel() + x.numel() + 4 * b * m * r)


def _int_mm_library(torch, a, x, layout: str, weights, ref):
    """The library yardstick of an int8 digit contraction: ``torch._int_mm``
    (cuBLASLt int8 on the tensor cores, exact int32 out), one call per
    digit group on the K-concatenated planes [A_0 ... A_g] @ [x_g; ...;
    x_0], timed and summed over the groups.  The operands, and the zero
    padding ``_int_mm`` demands (more than 16 rows, K and the output
    columns multiples of 8), are built outside the timing.  Its int32
    groups combined as the kernel combines must equal ``ref``, the plain
    version, bit for bit.  Returns (ms or None, note); the port never
    calls ``_int_mm``."""
    nd, m, _ = a.shape
    _, b, d1, d2 = x.shape
    k, r = (d1, d2) if layout == "left" else (d2, d1)
    xk = (x.transpose(2, 3) if layout == "left" else x).reshape(x.shape[0], b * r, k)
    pad = torch.nn.functional.pad
    calls = []
    for g in range(nd):
        pairs = [i for i in range(g + 1) if g - i < x.shape[0]]
        lhs = torch.cat([a[i, :, :k] for i in pairs], 1)        # [M, K']
        rhs = torch.cat([xk[g - i] for i in pairs], 1)          # [B R, K']
        kpad = -lhs.shape[1] % 8
        if layout == "left":                                    # [M, K'] @ [K', B R]
            mat1 = pad(lhs, (0, kpad)).contiguous()
            mat2 = pad(rhs, (0, kpad, 0, -rhs.shape[0] % 8)).contiguous().t()
        else:                                                   # [B R, K'] @ [K', M]
            mat1 = pad(rhs, (0, kpad)).contiguous()
            mat2 = pad(lhs, (0, kpad, 0, -m % 8)).contiguous().t()
        calls.append((mat1, mat2))
    try:
        outs = [torch._int_mm(m1, m2) for m1, m2 in calls]
    except RuntimeError as e:
        return None, "refused: " + str(e).strip().splitlines()[0]
    y = None
    for g, o in enumerate(outs):
        t = o.float() * weights[g]
        y = t if y is None else y + t
    if layout == "left":
        y = y[:, : b * r].reshape(m, b, r).permute(1, 0, 2)
    else:
        y = y[:, :m].reshape(b, r, m)
    torch.cuda.synchronize()
    if not torch.equal(y, ref):
        raise RuntimeError(f"torch._int_mm's int32 groups combined as the kernel combines "
                           f"differ from the plain version ({layout}, M={m} K={k} B={b} R={r})")
    ms = sum(cuda_ms(lambda m1=m1, m2=m2: torch._int_mm(m1, m2)) for m1, m2 in calls)
    return ms, f"{len(calls)} torch._int_mm calls, int32 groups == plain"


def _ptxas_lines(log: str, source: str) -> list[str]:
    """ptxas's registers and spills for each kernel of ``source`` in the
    build log, one line per kernel, and its performance warnings."""
    part = log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0] if log else ""
    lines, fn = [], None
    for ln in part.splitlines():
        if "Function properties for" in ln:
            fn, spill = ln.split("Function properties for")[1].strip(), ""
        elif "spill" in ln and fn:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn:
            lines.append(f"{fn}: {ln.split('info    :')[1].strip()}; {spill}")
            fn = None
        elif "Performance" in ln or "warning" in ln.lower():
            lines.append(ln.strip())
    return lines


def _sass_mma_counts(path: str) -> dict | None:
    """Tensor-core MMA instructions (warpgroup MMA: ``GMMA`` in their SASS
    name, ``IGMMA`` for int8, ``HGMMA`` for TF32) per kernel of the built
    library, from ``cuobjdump --dump-sass``; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and "GMMA" in ln:
            counts[fn] += 1
    return counts


def _check_mma(mma: dict | None, kernel: str, expect: int) -> None:
    """Print the tensor-core MMA count of every instance of ``kernel`` and
    fail unless there are ``expect`` instances, each with one or more."""
    if mma is None:
        print(f"SASS: cuobjdump not found; {kernel}'s tensor-core MMA count not read",
              flush=True)
        return
    got = {fn: n for fn, n in mma.items() if kernel in fn}
    print(f"SASS tensor-core MMA instructions per {kernel}: {json.dumps(got)}", flush=True)
    if len(got) != expect or not all(got.values()):
        raise RuntimeError(f"a {kernel} instance has no tensor-core MMA in its SASS: {got}")


def _profile_chain(torch, fn, label: str, runs: int = 5) -> None:
    """torch.profiler over ``runs`` calls of ``fn`` after a warm-up: device
    time per call from the kernel events, split into the int8 MMA kernel,
    its staging pass and everything else (the digit split, scales and
    casts), the device's idle share of the window and the kernels per
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print(f"profile {label}: the profiler saw no device events", flush=True)
        return
    groups = {"i8mm_kernel": 0.0, "stage_x_kernel": 0.0, "other": 0.0}
    busy, reach = 0.0, spans[0][0]
    for start, end, name in spans:
        key = next((g for g in groups if g in name), "other")
        groups[key] += (end - start) / 1e3 / runs
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    window = spans[-1][1] - spans[0][0]
    print(f"profile {label} ({runs} calls): {wall_ms:.3f} ms host wall per call; device "
          f"per call: int8 MMA kernel {groups['i8mm_kernel']:.3f} ms, its staging pass "
          f"{groups['stage_x_kernel']:.3f} ms, other kernels {groups['other']:.3f} ms; "
          f"{len(spans) / runs:.0f} device events per call; device idle "
          f"{100 * (1 - busy / window):.1f} % of the window", flush=True)


def _uniform_factor(d: int, h: int, w: int) -> np.ndarray:
    """motion's uniform renorm 2*sqrt2 / (s_z s_y s_x), s = sqrt2 at index
    0 and 1 elsewhere (reference motion.c:643-647)."""
    s = [np.where(np.arange(n) > 0, 1.0, np.sqrt(2.0)) for n in (d, h, w)]
    return 2.0 * np.sqrt(2.0) / (s[0][:, None, None] * s[1][None, :, None]
                                 * s[2][None, None, :])


def _lowpass_box(dims, box, boost) -> np.ndarray:
    """``boost`` inside the [0, box) corner of a (d, h, w) block, 0 outside:
    motion's bandpass with begin 0 and damp 0."""
    m = np.zeros(dims)
    m[: box[0], : box[1], : box[2]] = boost
    return m


BF_SHAPES = (("chroma 1080p", MOTION_NB, (16, 8, 8)),
             ("threshold 1080p luma 8^3", 32400, (8, 8, 8)),
             ("ragged", 37, (8, 5, 5)))


def _check_block_filter(torch, dev, block_filter, fft, shapes=BF_SHAPES) -> dict:
    """Kernel #3 against its plain version at three shapes, and against
    scipy float64 on the linear chroma shape.  Returns its JSON stats."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ms_by_shape": {}}
    for label, nb, dims in shapes:
        v = int(np.prod(dims))
        uf = _uniform_factor(*dims)
        filt = uf * _lowpass_box(dims, (4, 4, 4), 1.25) if label.startswith("chroma") else uf
        k2m_t, k3s_t, split = block_filter._folded_operands(dims, filt, 1.0 / uf, dev)
        x = torch.rand((nb, v), generator=gen, device=dev) * 255.0
        f = x @ k2m_t                       # the plain version's coefficients
        a = f.abs()
        sample = a[:4000].flatten()
        quant, tmin, tmax = 0.0, 0.0, 0.0
        if not label.startswith("chroma"):
            lo, hi = (0.45, 0.95) if label.startswith("threshold") else (0.2, 0.99)
            tmin, tmax = (float(torch.quantile(sample, q)) for q in (lo, hi))
        if label == "ragged":
            quant = float(torch.quantile(sample, 0.5)) / 4.0
        # a coefficient within the estimated kernel-vs-plain error of a
        # threshold or quant boundary may fall either way: its block is
        # left out of the comparison and counted
        band = block_filter.boundary_band(x, k2m_t)
        near = torch.zeros_like(a, dtype=torch.bool)
        if tmax:
            near |= ((a - tmin).abs() <= band) | ((a - tmax).abs() <= band)
            zeroed = float(((a < tmin) | (a > tmax)).float().mean())
        if quant:
            yq = block_filter._middle(f, 0.0, tmin, tmax).abs() * (1.0 / quant)
            half = torch.floor(yq) + 0.5
            near |= (yq - half).abs() <= band / quant
        keep = ~near.any(dim=1)
        del band
        args = (x, k2m_t, k3s_t, quant, tmin, tmax)
        y = block_filter._block_filter_cuda(*args, split)
        ref = block_filter._block_filter_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs()[keep].max())
        if not (np.isfinite(err) and err <= BF_TOL and bool(torch.isfinite(y).all())):
            raise RuntimeError(f"block filter {label}: max abs diff {err} vs plain "
                               f"(tolerance {BF_TOL})")
        msg = (f"kernel block_filter {label} NB={nb} V={v} dims={dims}: max abs diff vs "
               f"plain {err:.3e} over {int(keep.sum())} blocks "
               f"({nb - int(keep.sum())} excluded within band_c = "
               f"{block_filter.band_c(v):.2f} units of a boundary)")
        if tmax:
            msg += f", threshold zeroes {zeroed:.3f} of the coefficients"
        if quant:
            msg += f", quant {quant:.4g}"
        if label.startswith("chroma"):
            xb = x.double().cpu().numpy().reshape((nb,) + dims)
            axes = (1, 2, 3)
            ff = fft.dctn(xb, type=2, axes=axes, workers=-1) * filt * (1.0 / uf)
            oracle = fft.dctn(ff, type=3, axes=axes, workers=-1) / (8.0 * v)
            oracle = oracle.reshape(nb, v)
            oerr = float(np.max(np.abs(y.double().cpu().numpy() - oracle)))
            perr = float(np.max(np.abs(ref.double().cpu().numpy() - oracle)))
            msg += f"; vs float64 {oerr:.3e} (plain {perr:.3e})"
            out["f64_err"], out["plain_f64_err"] = oerr, perr
            if not oerr <= BF_TOL:
                raise RuntimeError(f"block filter {label}: {oerr} vs float64")
        ms = cuda_ms(lambda: block_filter._block_filter_cuda(*args, split))
        plain_ms = cuda_ms(lambda: block_filter._block_filter_plain(*args))
        # the split's three TF32 products of the two [NB, V] x [V, V]
        # products on the tensor cores; the unsplit products on the float32
        # FMA pipes beside it (the bound of the parent's kernel); the
        # library yardstick is the same two products in cuBLAS float32 with
        # the middle stage left out
        nbytes = 8.0 * nb * v + 8.0 * v * v
        bound_ms, bound_by = _bound(3 * 4.0 * nb * v * v, TF32_FLOPS, nbytes)
        fma_ms, _ = _bound(4.0 * nb * v * v, F32_FLOPS, nbytes)
        lib_ms = cuda_ms(lambda: (x @ k2m_t) @ k3s_t)
        print(f"{msg}; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms "
              f"({bound_by}, split TF32), {100 * bound_ms / ms:.1f} % of bound; float32 FMA "
              f"bound {fma_ms:.4f} ms; library {lib_ms:.4f} ms (two float32 torch.matmul), "
              f"kernel/library {ms / lib_ms:.3f}", flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms_by_shape"][label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "library_ms": lib_ms,
                                     "excluded": nb - int(keep.sum())}
        if label.startswith("chroma"):        # the motion path's shape
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
        del x, f, a, y, ref
    return out


def _write_clip(video, path: str | None, frames: int | None = None, hw=None) -> list:
    """A seeded MWxMH (or ``hw``) yuv420p y4m clip of MFRAMES frames (or
    its first ``frames``; smooth moving content plus noise), written with
    the port's Y4MWriter (unless ``path`` is None).  Returns the planes
    as [frames, h, w] uint8 arrays."""
    rng = np.random.default_rng(0)
    pf = video.PIXEL_FORMATS["yuv420p"]
    mh, mw = hw or (MH, MW)
    dims = pf.plane_dims(mw, mh)
    nframes = MFRAMES if frames is None else frames
    planes = [np.empty((nframes, h, w), np.uint8) for w, h in dims]
    writer = (contextlib.nullcontext() if path is None else
              video.open_output(path, mw, mh, Fraction(25, 1), video.ColorProps(pix_fmt="yuv420p")))
    with writer:
        for t in range(nframes):
            frame = []
            for i, (w, h) in enumerate(dims):
                sx = np.sin(np.arange(w) / (23.0 + 4 * i) + t / 7.0)
                cy = np.cos(np.arange(h) / 17.0 - t / 11.0)
                p = 128.0 + 70.0 * cy[:, None] * sx[None, :] \
                    + 8.0 * rng.standard_normal((h, w), dtype=np.float32)
                planes[i][t] = np.clip(np.rint(p), 0, 255)
                frame.append(planes[i][t])
            if path is not None:
                writer.write_frame(frame, raw=True)
    return planes


def _read_y4m(path: str, nframes: int):
    """(header line, [nframes, h, w] uint8 planes) of a yuv420p y4m file."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        tags = {t[0]: t[1:] for t in header.split()[1:]}
        w, h = int(tags["W"]), int(tags["H"])
        dims = [(w, h), ((w + 1) // 2, (h + 1) // 2), ((w + 1) // 2, (h + 1) // 2)]
        planes = [np.empty((nframes, ph, pw), np.uint8) for pw, ph in dims]
        for t in range(nframes):
            if f.readline() != b"FRAME\n":
                raise RuntimeError(f"{path}: frame {t} missing")
            for p, (pw, ph) in zip(planes, dims):
                p[t] = np.frombuffer(f.read(pw * ph), np.uint8).reshape(ph, pw)
        if f.read(1):
            raise RuntimeError(f"{path}: trailing bytes after {nframes} frames")
    return header, planes


def _motion_oracle(frames: np.ndarray, block, box, out_hw, fft) -> np.ndarray:
    """motion's lowpass edit in float64: per (d, h, w) block, scipy DCT-II,
    ``box`` boosted by 1.25 and the rest zeroed, DCT-III / (8V), then
    floor(x + 0.5) clipped to 0..255; rows and columns the block grid
    truncates are zero, as the tool pads them."""
    bd, bh, bw = block
    n, h, w = frames.shape
    nbh, nbw = h // bh, w // bw
    a = frames[:, : nbh * bh, : nbw * bw].astype(np.float64)
    a = a.reshape(n // bd, bd, nbh, bh, nbw, bw)
    mult = _lowpass_box(block, box, 1.25)[None, :, None, :, None, :]
    f = fft.dctn(a, type=2, axes=(1, 3, 5), workers=-1) * mult
    y = fft.dctn(f, type=3, axes=(1, 3, 5), workers=-1) / (8.0 * bd * bh * bw)
    y = np.clip(np.floor(y + 0.5), 0, 255).reshape(n, nbh * bh, nbw * bw)
    rows, cols = min(nbh * bh, out_hw[0]), min(nbw * bw, out_hw[1])
    out = np.zeros((n,) + tuple(out_hw))
    out[:, :rows, :cols] = y[:, :rows, :cols]
    return out


def _motion_phase(torch, dev, plain_versions, int8mm, block_filter, fft) -> dict:
    """Main path 2: the motion CLI at 1080p 4:2:0; returns its launches."""
    from dspfun_tpu_torch.io import video
    from dspfun_tpu_torch.models import motion_pipeline as mp
    from dspfun_tpu_torch.tools import motion

    nslabs = MFRAMES // 16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_motion_") as tmp:
        clip, out, out_plain = (os.path.join(tmp, n) for n in
                                ("clip.y4m", "out.y4m", "plain.y4m"))
        src = _write_clip(video, clip)

        def run(dst, extra=()):
            t0 = time.perf_counter()
            rc = motion.main(MOTION_ARGS + list(extra) + [clip, dst])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"motion CLI exited {rc}")
            return wall, dict(motion.LAST_STAGE_TIMES)

        int8mm.LAUNCHES.clear()
        block_filter.LAUNCHES.clear()
        cold, _ = run(out)
        launches = {**int8mm.LAUNCHES, **block_filter.LAUNCHES}
        print(f"motion main-path launches: {json.dumps(launches)} ({nslabs} slabs, "
              f"{cold:.3f} s cold)", flush=True)
        expect = {"right3": 2 * nslabs, "block_filter": 2 * nslabs}
        if {n: c for n, c in launches.items() if c} != expect:
            raise RuntimeError(f"motion launches {launches}, expected {expect}")
        if mp.LAST_FAST_PATH != "cuda-kron":
            raise RuntimeError(f"motion chroma took {mp.LAST_FAST_PATH}, not cuda-kron")

        header, got = _read_y4m(out, MFRAMES)
        print(f"motion output header: {header}", flush=True)
        # the 16-row block grid keeps 1072 of the 1080 rows
        if got[0].shape[1:] != (MH // 16 * 16, MW):
            raise RuntimeError(f"motion output plane 0 is {got[0].shape[1:]}")
        total = off = 0
        for i, (frames, plane) in enumerate(zip(src, got)):
            block, box = ((16, 16, 16), (4, 8, 8)) if i == 0 else ((16, 8, 8), (4, 4, 4))
            oracle = _motion_oracle(frames, block, box, plane.shape[1:], fft)
            diff = np.abs(plane.astype(np.float64) - oracle)
            total += diff.size
            off += int((diff > 0).sum())
            print(f"motion plane {i} {plane.shape}: max |pel - f64 oracle| "
                  f"{diff.max():.0f}, off by one {np.mean(diff > 0):.6f}", flush=True)
            if diff.max() > 1:
                raise RuntimeError(f"motion plane {i}: a pel is {diff.max()} levels "
                                   "from the float64 oracle")
        print(f"motion output vs float64: every pel within one level, "
              f"{off / total:.6f} off by one", flush=True)

        with plain_versions():
            run(out_plain)                      # warm the plain path's allocations
        warm_s, warm_stages = run(out)
        b2_s, b2_stages = run(out_plain, ("--slab-batch", "2"))
        _, got_b2 = _read_y4m(out_plain, MFRAMES)
        if not all(np.array_equal(a, b) for a, b in zip(got, got_b2)):
            raise RuntimeError("motion --slab-batch 2 output differs from batch 1")
        with plain_versions():
            plain_s, plain_stages = run(out_plain)
        _, got_plain = _read_y4m(out_plain, MFRAMES)
        ndiff = sum(int((a != b).sum()) for a, b in zip(got, got_plain))
        print(f"motion CLI 1080p 4:2:0, {MFRAMES} frames: {MFRAMES / warm_s:.2f} frames/s "
              f"with the kernels ({warm_s:.3f} s; stages {json.dumps(warm_stages)}), "
              f"{MFRAMES / plain_s:.2f} frames/s plain ({plain_s:.3f} s; stages "
              f"{json.dumps(plain_stages)}); {ndiff} pels differ kernel vs plain; "
              f"--slab-batch 2 {MFRAMES / b2_s:.2f} frames/s ({b2_s:.3f} s, same output)",
              flush=True)

    # slab time per plane (filter_blocks alone, blocks already on the card)
    geoms = mp.plan_geometry(MW, MH, MFRAMES, 3, 1, 1, block=mp.Dims(16, 16, 16),
                             bp_end=mp.Dims(8, 8, 4))
    params = mp.MotionParams(boost=1.25, damp=0.0, float_pixels=False)
    for i in (0, 1):
        g = geoms[i]
        plans = (*mp.make_plans(g, device=dev), mp.maybe_kron_plans(g, params, device=dev))
        blocks = torch.from_numpy(np.ascontiguousarray(
            mp.frames_to_blocks(src[i][:16], g))).to(dev)

        def slab(b=blocks, g=g, plans=plans, i=i):
            return mp.filter_blocks(b, plans, None, None, g, params, i, 3)

        ms = cuda_ms(slab)
        path = mp.LAST_FAST_PATH
        with plain_versions():
            plain_ms = cuda_ms(slab)
        print(f"motion slab plane {i} ({path}, NB={blocks.shape[0]}): {ms:.4f} ms "
              f"kernel, {plain_ms:.4f} ms plain", flush=True)
        if i == 0:
            sweep = {}
            for bsz in (1, 2, 4):
                big = blocks.repeat(bsz, 1, 1, 1)
                sweep[bsz] = cuda_ms(lambda: slab(big)) / bsz
            print("motion luma slab batch sweep (ms per slab): "
                  + ", ".join(f"B={b} {t:.4f}" for b, t in sweep.items()), flush=True)
    return launches


def _calib_phase(torch, dev, mma) -> dict:
    """Main path 3: the calibration counterparts on the card; returns the
    split kernel's launches, the int8 digit kernels' launches (calib_r3f's
    split + int8mm route) and per-instance stats."""
    from dspfun_tpu_torch import _build
    from dspfun_tpu_torch.benchmarks import calib_r3e, calib_r3f
    from dspfun_tpu_torch.ops import int8mm, int8split

    for line in _ptxas_lines(_build.build_log(), "int8split.cu"):
        print(f"ptxas int8split.cu {line}", flush=True)
    _check_mma(mma, "i8split_kernel",
               sum(len(tiles) for tiles in int8split.COMPILED_TILES.values()))

    int8split.LAUNCHES.clear()
    before = dict(int8mm.LAUNCHES)
    probes = calib_r3e.run_probes(dev)
    rows = calib_r3f.run(dev)
    torch.cuda.synchronize()
    launches = {n: int8split.LAUNCHES[n] for n in I8S_REPLACES}
    i8mm_launches = {n: int8mm.LAUNCHES[n] - before.get(n, 0) for n in REPLACES}
    print(f"calibration main-path launches: {json.dumps(launches)}, "
          f"int8mm {json.dumps(i8mm_launches)}", flush=True)
    if not i8mm_launches["left3"]:
        raise RuntimeError(f"calib_r3f's split + int8mm route never launched left3: "
                           f"{i8mm_launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a split-kernel instance never launched: {launches}")

    stats = {}
    a8, xf = calib_r3e.probe_inputs()
    a, x = torch.tensor(a8, device=dev), torch.tensor(xf, device=dev)
    for probe, (planes, inst) in calib_r3e.PROBES.items():
        ap = torch.stack([a] * planes)
        ref = int8split._i8_split_plain(ap, x, **inst)
        torch.cuda.synchronize()
        if not torch.equal(probes[probe], ref):
            err = float((probes[probe] - ref).abs().max())
            raise RuntimeError(f"probe {probe}: kernel != plain (max abs diff {err})")
        ms = cuda_ms(lambda: int8split._i8_split_cuda(ap, x, **inst))
        plain_ms = cuda_ms(lambda: int8split._i8_split_plain(ap, x, **inst))
        name = int8split.INSTANCES[(inst["xdigits"], inst["groups"], inst["scale"])]
        m, k, r = calib_r3e.M, calib_r3e.K, calib_r3e.R
        bound_ms, bound_by = _bound(2.0 * m * k * r * _pairs(planes, inst["xdigits"]),
                                    INT8_OPS, ap.numel() + 4 * k * r + 4 * m * r)
        print(f"probe {probe} ({name}) M={m} K={k} R={r}: equal, {ms:.4f} ms kernel, "
              f"{plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.2f} % of bound; library none (a launch-bound probe)",
              flush=True)
        stats.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    by_route = {row["route"]: row for row in rows}
    plain, route1 = by_route["plain"]["out"], by_route["split + int8mm"]["out"]
    for row in rows:
        same = torch.equal(row["out"], plain) and torch.equal(row["out"], route1)
        print(f"calib_r3f K={calib_r3f.K} M={calib_r3f.M} R={calib_r3f.R} {row['route']}: "
              f"rel={row['rel']:.3e} {row['ms']:.4f} ms {row['tops']:.2f} eff-TOPS(int8), "
              f"== plain and == split + int8mm: {same}", flush=True)
        if not (same and row["rel"] <= CALIB_TOL):
            raise RuntimeError(f"calib_r3f {row['route']} failed (rel {row['rel']})")
    fused = [row for row in rows if row["route"].startswith("fused")]
    default = fused[int8split.COMPILED_TILES["exp3g3"].index(int8split.DEFAULT_TILE)]
    # kernel #5's yardstick: torch._int_mm on the digits split beforehand
    a, _, x, _ = calib_r3f.inputs(device=dev)
    xd, _ = int8mm._split_operand(x.reshape(1, *x.shape), 1)
    lib_ms, note = _int_mm_library(torch, a, xd, "left", int8mm._W,
                                   int8mm._i8_groups_plain(a, xd, "left"))
    m, k, r = calib_r3f.M, calib_r3f.K, calib_r3f.R
    bound_ms, bound_by = _bound(2.0 * m * k * r * _pairs(3, 3), INT8_OPS,
                                a.numel() + 4 * k * r + 4 * m * r)
    print(f"calib_r3f fused (default tile) {default['ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / default['ms']:.1f} % of bound; library "
          + (f"{lib_ms:.4f} ms ({note})" if lib_ms else note), flush=True)
    del a, x, xd
    stats["exp3g3"] = {"max_abs_err": 0.0, "ms": default["ms"],
                       "plain_ms": by_route["plain"]["ms"],
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                       "split_then_int8mm_ms": by_route["split + int8mm"]["ms"],
                       "sweep_ms": {row["route"]: row["ms"] for row in fused}}
    return {"launches": launches, "i8mm_launches": i8mm_launches, "stats": stats}


def _png_codec_checks(png, hw) -> None:
    """The PNG codec alone: every filter at both depths reads back equal
    at a small size; then, at ``hw`` in 8-bit RGB, the seconds to encode
    and to decode per filter (None = the filter chosen per row)."""
    rng = np.random.default_rng(2)
    y, x = np.mgrid[0:48, 0:64]
    for dtype, top in ((np.uint8, 255), (np.uint16, 65535)):
        a = np.stack([(0.5 + 0.4 * np.sin(x / (7.0 + i) + y / 11.0)) * top * 0.9
                      for i in range(3)], -1) + rng.integers(0, top // 40, (48, 64, 3))
        a = a.astype(dtype)
        for ftype in (None, 0, 1, 2, 3, 4):
            back, props, _ = png.decode_png(png.encode_png(a, {"k": "v"}, ftype))
            if not (np.array_equal(back, a) and back.dtype == dtype and props == {"k": "v"}):
                raise RuntimeError(f"PNG round trip failed: {dtype.__name__} filter {ftype}")
    print("png codec: filters None, 0-4 at 8 and 16 bits read back equal (64x48 RGB)",
          flush=True)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(0.5 + 0.4 * np.sin(x / (70.0 + i) + y / 110.0)) * 229.0
                  for i in range(3)], -1) + rng.integers(0, 6, (h, w, 3))
    a = a.astype(np.uint8)
    for ftype in (None, 0, 1, 2, 3, 4):
        t0 = time.perf_counter()
        data = png.encode_png(a, None, ftype)
        t1 = time.perf_counter()
        back = png.decode_png(data)[0]
        t2 = time.perf_counter()
        if not np.array_equal(back, a):
            raise RuntimeError(f"PNG round trip at {w}x{h} failed: filter {ftype}")
        print(f"png codec {w}x{h} 8-bit RGB filter {ftype}: encode {t1 - t0:.3f} s, "
              f"decode {t2 - t1:.3f} s (host), {len(data)} bytes", flush=True)


def _ulps(torch, a, b):
    """Distance between two float32 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _fp64_beside_exact(torch, dev, hw) -> None:
    """A float64 contraction rounded to float32 beside ``core/exact.py``'s
    digit contraction, at the two shapes spec's default policy runs."""
    from dspfun_tpu_torch.core.basis import dct2_matrix
    from dspfun_tpu_torch.core.precision import Precision
    from dspfun_tpu_torch.core.transforms import apply_plan, plan_axis

    exact = Precision(intermediate="exact")
    h, w = hw
    x = torch.rand((h, w, C), generator=torch.Generator(device=dev).manual_seed(8),
                   device=dev)
    for axis, n in ((0, h), (1, w)):
        plan = plan_axis(n, "dct2", exact, dev)
        m64 = torch.tensor(dct2_matrix(n), dtype=torch.float64, device=dev)

        def by_digits():
            return apply_plan(x, plan, axis, exact)

        def by_fp64():
            y = torch.tensordot(m64, x.double(), dims=([1], [axis]))
            return y.movedim(0, axis).float()

        ye, y64 = by_digits(), by_fp64()
        d = _ulps(torch, ye, y64)
        rel = float((ye - y64).abs().max() / ye.abs().max())
        print(f"fp64 beside exact, DCT-II along axis {axis} of [{h}, {w}, {C}] (K={n}): "
              f"exact {cuda_ms(by_digits):.3f} ms, fp64 rounded to float32 "
              f"{cuda_ms(by_fp64):.3f} ms; largest distance {int(d.max())} ulp, "
              f"{int((d > 0).sum())} of {d.numel()} outputs differ, "
              f"{int((d > 1).sum())} by more than 1 ulp; max abs diff "
              f"{rel:.3e} of the largest output", flush=True)
        del ye, y64, d, m64
    del x
    torch.cuda.empty_cache()


def _spec_cli_phase(torch, dev, plain_versions, int8mm, fft, hw=(H, W)) -> dict:
    """Main path 4: spec then ispec through 16-bit PNG files; returns the
    int8 kernels' launches over the i8@1e-5 run."""
    from dspfun_tpu_torch.io import images, png
    from dspfun_tpu_torch.tools import ispec, spec

    h, w = hw
    _png_codec_checks(png, hw)

    def levels(path):
        arr, props, _ = png.decode_png(open(path, "rb").read())
        if arr.dtype != np.uint16 or arr.shape != (h, w, C):
            raise RuntimeError(f"{path}: {arr.dtype} {arr.shape}")
        return arr.astype(np.int64), props

    def tool(main, mod, args, expect):
        if expect:      # the counts start at 0 for a run that must launch
            int8mm.LAUNCHES.clear()
        before = dict(int8mm.LAUNCHES)
        t0 = time.perf_counter()
        rc = main(args)
        wall = time.perf_counter() - t0
        got = {n: c - before.get(n, 0) for n, c in int8mm.LAUNCHES.items()
               if c - before.get(n, 0)}
        if rc != 0:
            raise RuntimeError(f"{mod.__name__.rsplit('.', 1)[-1]} {args} exited {rc}")
        if got != expect:
            raise RuntimeError(f"{mod.__name__} launched {got}, expected {expect}")
        return wall, dict(mod.LAST_STAGE_TIMES), got

    def round_trip(tmp, tag, template, expect):
        s, b = (os.path.join(tmp, f"{n}_{template}_{tag.replace(' ', '_')}.png")
                for n in ("spec", "back"))
        runs = [tool(spec.main, spec, ["-t", template, src, s], expect),
                tool(ispec.main, ispec, ["-t", template, s, b], expect)]
        for name, (wall, stages, got) in zip(("spec", "ispec"), runs):
            stages = {k: round(v, 4) for k, v in stages.items()}
            print(f"{name} -t {template} ({tag}) {w}x{h}: {wall:.3f} s wall; stages (s) "
                  f"{json.dumps(stages)}; launches {json.dumps(got)}", flush=True)
        return s, b, [r[2] for r in runs]

    scale = [np.where(np.arange(n) > 0, np.sqrt(2.0), 1.0) for n in (h, w)]
    grid = scale[0][:, None, None] * scale[1][None, :, None]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spec_") as tmp:
        src = os.path.join(tmp, "in.png")
        rng = np.random.default_rng(7)
        y, x = np.mgrid[0:h, 0:w]
        pix = np.stack([0.5 + 0.2 * np.sin(x / (190.0 + 30 * i) + y / 130.0)
                        for i in range(C)], -1)
        pix += 0.2 * (rng.random((h, w, C)) - 0.5)            # within [0.2, 0.8]
        t0 = time.perf_counter()
        images.write_image(src, pix, depth=16)
        print(f"input {w}x{h} RGB 16-bit PNG: written in {time.perf_counter() - t0:.3f} s, "
              f"{os.path.getsize(src)} bytes", flush=True)
        del pix, x, y
        lv_in, _ = levels(src)
        # what the tools compute on: the float32 of the file's levels
        x32 = (lv_in / 65535.0).astype(np.float32).astype(np.float64)
        uniform = fft.dctn(x32, type=2, axes=(0, 1), workers=-1) * grid / (4.0 * w * h)
        means = x32.mean(axis=(0, 1))
        del x32

        def check_spectrum(path, template):
            """The file against the float64 chain of the reference
            (spec.c:63-139; flat and copy: linear scale, range one)."""
            lv, props = levels(path)
            f = (uniform / 2 + 0.5) * 254 / 255 if template == "flat" else uniform
            diff = np.abs(lv - np.rint(np.clip(f, 0, 1) * 65535).astype(np.int64))
            dc = images.decode_dc_property(props["DC"], C)
            dc_err = float(np.max(np.abs(dc - means)))
            print(f"spec -t {template} file vs float64 oracle: largest difference "
                  f"{int(diff.max())} level, {float((diff > 0).mean()):.6f} of the pels off "
                  f"by one; DC vs channel means {dc_err:.3e}", flush=True)
            if diff.max() > 1 or not dc_err <= 1e-6:
                raise RuntimeError(f"spec -t {template}: the file disagrees with the oracle")
            return lv

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _policy(None):
            s_flat, b_flat, _ = round_trip(tmp, "default", "flat", {})
            peak = torch.cuda.max_memory_allocated()
            s_copy, b_copy, _ = round_trip(tmp, "default", "copy", {})
        print(f"peak device memory over spec + ispec -t flat at the default policy "
              f"(hilo -> exact): {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB held before)", flush=True)

        check_spectrum(s_flat, "flat")
        back, _ = levels(b_flat)
        d = back - lv_in
        sigma = FLAT_FILE_NOISE * np.sqrt(h * w)
        rms, worst = float(np.sqrt(np.mean(d * d.astype(np.float64)))), int(np.abs(d).max())
        print(f"spec -> ispec -t flat through 16-bit files: back vs input {rms:.1f} levels "
              f"rms (the spectrum's quantisation leaves {sigma:.1f}), largest {worst} "
              f"(limit {7 * sigma:.0f})", flush=True)
        if abs(rms / sigma - 1) > 0.05 or worst > 7 * sigma:
            raise RuntimeError("spec -> ispec -t flat: outside the file format's noise")

        lv = check_spectrum(s_copy, "copy")
        coeff = lv / 65535.0 / grid * (4.0 * w * h)
        oracle = fft.dctn(coeff, type=3, axes=(0, 1), workers=-1) / (4.0 * w * h)
        back, _ = levels(b_copy)
        diff = np.abs(back - np.rint(np.clip(oracle, 0, 1) * 65535).astype(np.int64))
        print(f"ispec -t copy file vs a float64 inverse of the spectrum file "
              f"({float((lv == 0).mean()):.3f} of its coefficients clipped at 0): largest "
              f"difference {int(diff.max())} level, {float((diff > 0).mean()):.6f} off by one",
              flush=True)
        if diff.max() > 1:
            raise RuntimeError("ispec -t copy: the file disagrees with the oracle")
        del coeff, oracle, back, diff, lv, d

        with _policy("i8@1e-5"):
            s_i8, b_i8, counts = round_trip(tmp, "i8@1e-5", "flat", SPEC_CLI_EXPECT)
            with plain_versions():
                s_pl, b_pl, _ = round_trip(tmp, "i8@1e-5 plain", "flat", {})
        same = [open(a, "rb").read() == open(b, "rb").read()
                for a, b in ((s_i8, s_pl), (b_i8, b_pl))]
        check_spectrum(s_i8, "flat")
        print(f"spec, ispec -t flat at i8@1e-5: files byte-equal kernel vs plain: {same}",
              flush=True)
        if not all(same):
            raise RuntimeError("spec/ispec at i8@1e-5: kernel and plain files differ")
    launches = {n: sum(c.get(n, 0) for c in counts) for n in REPLACES}
    print(f"spec CLI main-path launches: {json.dumps(launches)}", flush=True)
    _fp64_beside_exact(torch, dev, hw)
    return launches


# ---------------------------------------------------------------------------
# phases 9 and 10: the scan and zoom CLIs
# ---------------------------------------------------------------------------

SCAN_HW = (256, 256)              # BASELINE.md item 4
SCAN_STEPS = (16, 64)             # -S for the y4m and the fvid run (every index is
#                                   scanned; the 65,536-frame schedule at -S 1 is
#                                   12.9 GB of y4m)
SCAN_BIG = dict(hw=(1080, 1920), step=4, frames=128, float_frames=16)
ZOOM_HW = (1080, 1920)            # BASELINE.md item 2: 1080p, 4x, -g
ZOOM_SCALE = 4
ZOOM_PAN_FRAMES = 24
ZOOM_DEV = dict(hw=(768, 1024), scale=2, frames=12, xstep=64, ystep=32)
ZOOM_SMALL = (240, 320)
LEVEL = 1.0 / 255.0
TOOL_TOL = 1e-5                   # BASELINE.md: max abs error vs float64
# zoom's device route at i8@tol splits both operands of both contractions
# into 3 digits at run time and misses TOOL_TOL (printed as MISS); it is
# held to this many standard deviations of the split's rounding model
# (_rt_split_sigma), about the largest of 2.4 M independent outputs
RT_SPLIT_SIGMAS = 6.0


@contextlib.contextmanager
def _policy(name):
    """The tools' own default policy (None) or a named one, then back."""
    from dspfun_tpu_torch.core import precision as prec

    saved = (prec._default, prec._explicit)
    if name is None:
        prec._default, prec._explicit = prec.Precision(), False
    else:
        prec.set_precision(prec.Precision.parse(name))
    try:
        yield
    finally:
        prec._default, prec._explicit = saved


def _run_tool(torch, mod, args, int8mm):
    """``mod.main(args)`` with the int8 kernels' launches counted over
    this call alone: (wall seconds, stage seconds, launches)."""
    before = dict(int8mm.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = mod.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{mod.__name__.rsplit('.', 1)[-1]} {args} exited {rc}")
    got = {n: c - before.get(n, 0) for n, c in int8mm.LAUNCHES.items()}
    return wall, dict(mod.LAST_STAGE_TIMES), {n: c for n, c in got.items() if c}


def _stages(st: dict) -> str:
    out = {}
    for k, v in st.items():
        if k == "chunk_device_ms":
            out["chunk_device_ms_median"] = round(float(np.median(v)), 4)
            out["chunk_device_s_total"] = round(float(np.sum(v)) / 1e3, 4)
        elif k == "routes":
            out[k] = {r: v.count(r) for r in sorted(set(v))}
        else:
            out[k] = round(v, 4) if isinstance(v, float) else v
    return json.dumps(out)


def _seeded_pixels(hw, seed, noise=0.1):
    """Seeded float RGB pixels: smooth terms plus noise, inside 0.2..0.8."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    pix = np.stack([0.5 + 0.2 * np.sin(x / (19.0 + 3 * i) * 256.0 / w + y / 13.0 * 256.0 / h)
                    for i in range(C)], -1)
    return pix + noise * 2.0 * (rng.random((h, w, C)) - 0.5)


def _seeded_png(images, path, hw, seed, noise=0.1):
    """A seeded 8-bit RGB PNG of ``_seeded_pixels``; returns the float32
    pixels of its levels, which the tools compute on."""
    images.write_image(path, _seeded_pixels(hw, seed, noise))
    return images.read_image(path).pixels.astype(np.float32)


def _stream_frame(video, path, index):
    """Frame ``index`` of a y4m or fvid file: (reader, list of planes in
    the container's dtype), read at its offset."""
    r = video.open_input(path)
    pf, w, h = r.pix_fmt, r.width, r.height
    r.close()
    with open(path, "rb") as f:
        hdr = len(f.readline())
        fsize = pf.frame_bytes(w, h)
        f.seek(hdr + index * (6 + fsize) + 6)
        data = f.read(fsize)
    if len(data) != fsize:
        raise RuntimeError(f"{path}: frame {index} is not there")
    planes, off = [], 0
    for pw, ph in pf.plane_dims(w, h):
        n = pw * ph * pf.dtype.itemsize
        planes.append(np.frombuffer(data[off:off + n], pf.dtype).reshape(ph, pw))
        off += n
    return r, planes


def _frame_rgb_error(video, path, index, ref_rgb):
    """Largest distance of frame ``index`` from the float64 RGB frame
    ``ref_rgb``: for an integer container in its own levels after the
    host writers' float64 conversion of the oracle (also the share of
    samples off by one), for a float container in value."""
    r, planes = _stream_frame(video, path, index)
    want = video.rgb_to_planes(ref_rgb, r.pix_fmt, r.props)
    if r.pix_fmt.is_float:
        return max(float(np.max(np.abs(p.astype(np.float64) - q))) for p, q in zip(planes, want)), 0.0
    worst, off, total = 0, 0, 0
    for i, (p, q) in enumerate(zip(planes, want)):
        d = np.abs(p.astype(np.int64)
                   - video._quantize_plane(q, r.pix_fmt, i, r.props.color_range).astype(np.int64))
        worst, off, total = max(worst, int(d.max())), off + int((d > 0).sum()), total + d.size
    return worst, off / total


def _oracle_dct3(torch, dev, n):
    """FFTW's REDFT01 matrix from its closed form, float64 on the card:
    M[k, j] = 2 cos(pi j (2k + 1) / (2n)), column 0 all ones."""
    k = torch.arange(n, dtype=torch.float64, device=dev)[:, None]
    j = torch.arange(n, dtype=torch.float64, device=dev)[None, :]
    m = 2.0 * torch.cos(np.pi * j * (2.0 * k + 1.0) / (2.0 * n))
    m[:, 0] = 1.0
    return m


def _zigzag_walk(w, h):
    """The zigzag order walked diagonal by diagonal (y descending on even
    diagonals, ascending on odd ones): (ys, xs)."""
    ys = []
    for d in range(w + h - 1):
        y = np.arange(max(0, d - w + 1), min(d, h - 1) + 1, dtype=np.int64)
        ys.append(y[::-1] if d % 2 == 0 else y)
    ys = np.concatenate(ys)
    ds = np.repeat(np.arange(w + h - 1), [min(d, h - 1) - max(0, d - w + 1) + 1
                                          for d in range(w + h - 1)])
    return ys, ds - ys


def _scan_oracle(torch, dev, x32, order, step, nframes, keep, chunk=64):
    """scan's running reconstructions in float64 on the card, from scipy's
    DCT of the float32 pixels and the same schedule: returns ({frame:
    [H, W, C] numpy} for ``keep``, parity flags, and which of them the
    oracle decides further than TOOL_TOL from a rounding boundary)."""
    import scipy.fft

    h, w, _ = x32.shape
    c = scipy.fft.dctn(x32.astype(np.float64), type=2, axes=(0, 1), workers=-1) / (4.0 * w * h)
    cd = torch.tensor(c, device=dev)
    bh, bw = _oracle_dct3(torch, dev, h), _oracle_dct3(torch, dev, w)
    zy, zx = _zigzag_walk(w, h)
    if not (np.array_equal(order.ys, zy) and np.array_equal(order.xs, zx)
            and np.array_equal(order.starts, np.arange(w * h + 1)) and order.limit == w * h):
        raise RuntimeError("the zigzag schedule is not the diagonal walk")
    orig = torch.tensor(x32.astype(np.float64), device=dev)
    ys = torch.tensor(order.ys.astype(np.int64), device=dev)
    xs = torch.tensor(order.xs.astype(np.int64), device=dev)
    starts = order.starts
    limit = order.limit
    frame_of = torch.empty(len(order.ys), dtype=torch.int64, device=dev)
    for f in range(nframes):
        a, b = starts[min(f * step, limit)], starts[min((f + 1) * step, limit)]
        frame_of[a:b] = f
    ncoef = int(starts[min(nframes * step, limit)])
    carry = cd[0, 0].expand(h, w, C).clone()
    nodc = cd.clone()
    nodc[0, 0] = 0.0
    kept, parity, safe = {}, [], []

    def lround(t):
        return torch.sign(t) * torch.floor(torch.abs(t) + 0.5)

    for f0 in range(0, nframes, chunk):
        n = min(chunk, nframes - f0)
        sel = torch.nonzero((frame_of[:ncoef] >= f0) & (frame_of[:ncoef] < f0 + n))[:, 0]
        grid = torch.zeros((n, h, w, C), dtype=torch.float64, device=dev)
        grid[frame_of[sel] - f0, ys[sel], xs[sel]] = nodc[ys[sel], xs[sel]]
        delta = torch.einsum("jv,fvuc,iu->fjic", bh, grid, bw)
        sums = carry[None] + torch.cumsum(delta, 0)
        carry = sums[-1].clone()
        scaled = sums * 255.0
        same = (lround(scaled) == lround(orig * 255.0)[None]).reshape(n, -1)
        clear = ((scaled - torch.floor(scaled) - 0.5).abs() > TOOL_TOL * 255.0).reshape(n, -1)
        parity += same.all(1).tolist()
        safe += ((~same & clear).any(1) | clear.all(1)).tolist()
        for f in keep:
            if f0 <= f < f0 + n:
                kept[f] = sums[f - f0].cpu().numpy()
    return kept, np.asarray(parity), np.asarray(safe)


def _parity_index(err: str, total: int) -> int:
    for line in err.splitlines():
        if "Reached parity" in line:
            return int(line.rsplit(" ", 1)[1])
        if "Didn't reach parity" in line:
            return total
    raise RuntimeError(f"scan -P printed no parity line: {err[-300:]!r}")


def _scan_phase(torch, dev, plain_versions, int8mm, check_i8mm, fft, hw=SCAN_HW,
                steps=SCAN_STEPS, big=SCAN_BIG) -> dict:
    """Main path 5: the scan CLI; returns the int8 kernels' launches of
    the i8@1e-5 run and the kernel's stats at the chunk's shape."""
    import io

    from dspfun_tpu_torch.io import images, video
    from dspfun_tpu_torch.ops import scan_methods, speclib
    from dspfun_tpu_torch.tools import scan

    h, w = hw
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_") as tmp:
        src = os.path.join(tmp, "in.png")
        x32 = _seeded_png(images, src, hw, 11)
        order = scan_methods.get_method("zigzag").build(w, h)
        chunk = int(max(4, min(64, 16_000_000 // (w * h * C))))

        # ---- (a) every index, to y4m (packed on the device) and to fvid, with -P
        results = {}
        for ext, step in zip(("y4m", "fvid"), steps):
            out = os.path.join(tmp, f"a.{ext}")
            nfr = -(-order.limit // step)
            keep = sorted({nfr // 4, nfr // 2, 3 * nfr // 4, nfr - 1})
            with _policy(None), contextlib.redirect_stderr(io.StringIO()) as err:
                wall, st, got = _run_tool(torch, scan, ["-m", "zigzag", "-S", str(step), "-P", "-q",
                                                        src, out], int8mm)
            if got:
                raise RuntimeError(f"scan at the default policy launched {got}")
            kept, par, safe = _scan_oracle(torch, dev, x32, order, step, nfr, keep)
            worst, share = 0.0, 0.0
            for f in keep:
                e, s = _frame_rgb_error(video, out, f, kept[f])
                worst, share = max(worst, e), max(share, s)
            p = _parity_index(err.getvalue(), nfr)
            first = int(np.argmax(par)) if par.any() else nfr
            ok_parity = not (par[:p] & safe[:p]).any() and (p == nfr or par[p] or not safe[p])
            limit = 1 if ext == "y4m" else TOOL_TOL
            print(f"scan {w}x{h} -m zigzag -S {step} -P to {ext}: {nfr} frames in {wall:.3f} s "
                  f"({nfr / wall:.1f} frames/s); stages (s) {_stages(st)}; frames {keep} vs the "
                  f"float64 oracle: largest difference {worst:.3e}"
                  + (f" level, {share:.6f} off by one" if ext == "y4m" else "")
                  + f"; parity index {p} (oracle {first}, {int(safe.sum())} of {nfr} frames "
                  f"decided beyond {TOOL_TOL:g}): {'consistent' if ok_parity else 'INCONSISTENT'}",
                  flush=True)
            if st["frames"] != nfr or worst > limit or not ok_parity:
                raise RuntimeError(f"scan to {ext} disagrees with the float64 oracle")
            results[ext] = (out, nfr)

        # ---- (b) the same at i8@1e-5: launches, and kernel == plain byte for byte
        step = steps[0]
        nfr = results["y4m"][1]
        nchunks = -(-nfr // chunk)
        expect = {"left3": 2 + 2 * nchunks}     # forward H and W, then two per dense chunk
        ki, kp = (os.path.join(tmp, n) for n in ("i8.y4m", "i8_plain.y4m"))
        with _policy("i8@1e-5"):
            wall, st, got = _run_tool(torch, scan, ["-m", "zigzag", "-S", str(step), "-q", src, ki],
                                      int8mm)
            with plain_versions():
                pwall, pst, _ = _run_tool(torch, scan, ["-m", "zigzag", "-S", str(step), "-q",
                                                        src, kp], int8mm)
        same = open(ki, "rb").read() == open(kp, "rb").read()
        kept, _, _ = _scan_oracle(torch, dev, x32, order, step, nfr, [nfr // 2, nfr - 1])
        worst = max(_frame_rgb_error(video, ki, f, kept[f])[0] for f in kept)
        print(f"scan {w}x{h} -S {step} at i8@1e-5: launches {json.dumps(got)} (expected "
              f"{json.dumps(expect)}: {nchunks} chunks of {chunk} frames), {nfr / wall:.1f} frames/s "
              f"({wall:.3f} s; stages {_stages(st)}); plain forced {nfr / pwall:.1f} frames/s "
              f"({pwall:.3f} s; stages {_stages(pst)}); files byte-equal kernel vs plain: {same}; "
              f"vs the float64 oracle {worst} level", flush=True)
        if got != expect or not same or worst > 1:
            raise RuntimeError("scan at i8@1e-5 failed")
        launches = dict(got)
        # the kernel at the dense chunk's shape (both contractions go left)
        i8_stats = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                            check_i8mm(3, "left", h, h, 1, chunk * w * C, "scan chunk")))

        # ---- (c) 1080p: dense against pruned
        bh_, bw_ = big["hw"]
        bsrc = os.path.join(tmp, "big.png")
        bx32 = _seeded_png(images, bsrc, big["hw"], 12)
        border = scan_methods.get_method("zigzag").build(bw_, bh_)
        base = ["-m", "zigzag", "-S", str(big["step"]), "-q"]
        chunk_ms = {}
        for pruned in ("false", "true"):
            with _policy(None):
                wall, st, got = _run_tool(torch, scan, base + ["-n", str(big["frames"]), "-p", pruned,
                                                               bsrc, os.path.join(tmp, f"p_{pruned}.y4m")],
                                          int8mm)
                _run_tool(torch, scan, base + ["-n", str(big["float_frames"]), "-p", pruned, bsrc,
                                               os.path.join(tmp, f"p_{pruned}.fvid")], int8mm)
            chunk_ms[pruned] = float(np.median(st["chunk_device_ms"]))  # CUDA events, on a card
            print(f"scan {bw_}x{bh_} -S {big['step']} -n {big['frames']} -p {pruned} to y4m: "
                  f"{big['frames'] / wall:.1f} frames/s ({wall:.3f} s); stages {_stages(st)}; "
                  f"launches {json.dumps(got)}", flush=True)
        keep = [0, big["float_frames"] // 2, big["float_frames"] - 1]
        kept, _, _ = _scan_oracle(torch, dev, bx32, border, big["step"], big["float_frames"], keep,
                                  chunk=4)
        errs = {p: max(_frame_rgb_error(video, os.path.join(tmp, f"p_{p}.fvid"), f, kept[f])[0]
                       for f in keep) for p in ("false", "true")}
        between = max(float(np.max(np.abs(a.astype(np.float64) - b)))
                      for f in keep
                      for a, b in zip(_stream_frame(video, os.path.join(tmp, "p_false.fvid"), f)[1],
                                      _stream_frame(video, os.path.join(tmp, "p_true.fvid"), f)[1]))
        ya, yb = (open(os.path.join(tmp, f"p_{p}.y4m"), "rb").read() for p in ("false", "true"))
        d = np.abs(np.frombuffer(ya, np.uint8).astype(np.int16) - np.frombuffer(yb, np.uint8))
        print(f"scan {bw_}x{bh_} dense against pruned: chunk of "
              f"{int(max(4, min(64, 16_000_000 // (bw_ * bh_ * C))))} frames {chunk_ms['false']:.4f} ms "
              f"dense, {chunk_ms['true']:.4f} ms pruned (CUDA events, median); fvid frames {keep} vs "
              f"the float64 oracle: dense {errs['false']:.3e}, pruned {errs['true']:.3e}, dense vs "
              f"pruned {between:.3e}; y4m files differ by at most {int(d.max())} level on "
              f"{float((d > 0).mean()):.6f} of the samples", flush=True)
        if max(errs.values()) > TOOL_TOL or between > TOOL_TOL or d.max() > 1:
            raise RuntimeError("scan dense and pruned disagree")

        # ---- (d) the panes of -v -s -i against a host-only float64 oracle
        step, nfr = max(1, (w * h) // 16), 16
        out = os.path.join(tmp, "panes.y4m")
        with _policy(None):
            wall, st, _ = _run_tool(torch, scan, ["-m", "zigzag", "-v", "-s", "-i", "-S", str(step),
                                                  "-q", src, out], int8mm)
        c = fft.dctn(x32.astype(np.float64), type=2, axes=(0, 1), workers=-1) / (4.0 * w * h)
        scaler = speclib.SpecScaler(params=speclib.SpecParams(), max_input=float(c[0, 0].max()),
                                    gain=127.5 * np.sqrt(w * h * 4))
        kept, _, _ = _scan_oracle(torch, dev, x32, order, step, nfr, list(range(nfr)))
        canvas = np.zeros((2 * h, 2 * w, C))
        worst, share, prev = 0, 0.0, np.broadcast_to(c[0, 0], (h, w, C))
        for f in range(nfr):
            a, b = order.starts[f * step], order.starts[min((f + 1) * step, order.limit)]
            ys, xs = order.ys[a:b], order.xs[a:b]
            norm = np.where(xs > 0, np.sqrt(2.0), 1.0) * np.where(ys > 0, np.sqrt(2.0), 1.0)
            canvas[ys, xs + w] = scaler.scale(c[ys, xs] * norm[:, None], xp=np)
            canvas[ys + h, xs + w] = canvas[ys, xs + w]
            canvas[:h, :w] = kept[f]
            canvas[h:, :w] = kept[f] - prev + c[0, 0]     # this frame's delta over the DC
            prev = kept[f]
            e, s = _frame_rgb_error(video, out, f, canvas.astype(np.float32).astype(np.float64))
            worst, share = max(worst, e), max(share, s)
            canvas[ys + h, xs + w] = 0.0
        print(f"scan {w}x{h} -v -s -i -S {step}: {nfr} frames of {2 * w}x{2 * h} in {wall:.3f} s "
              f"(stages {_stages(st)}); panes vs the host float64 oracle: largest difference "
              f"{worst} level, {share:.6f} off by one", flush=True)
        if worst > 1:
            raise RuntimeError("scan's panes disagree with the oracle")
    return {"launches": launches, "stats": i8_stats}


def _oracle_zoom_basis(torch, dev, scaling, scale, offset, nvectors, n):
    """zoom's synthesis matrix [nvectors, n] for an upscale (``scale`` >= 1,
    so every frequency takes part) from its closed form, float64 on the
    card: cos(pi (k + 1/2) j / N), column 0 all 1/2, with (k, N) =
    ((b + offset) / scale, n) interpolated, (b + offset, n scale) native,
    ((b + offset)(n - 1) / (n scale - 1), n) centered (zoom/zoom.c:36-68)."""
    b = torch.arange(nvectors, dtype=torch.float64, device=dev)[:, None] + offset
    j = torch.arange(n, dtype=torch.float64, device=dev)[None, :]
    k, big_n = {"interpolated": (b / scale, float(n)), "native": (b, n * scale),
                "centered": (b * (n - 1) / (n * scale - 1.0), float(n))}[scaling]
    m = torch.cos(np.pi * (k + 0.5) * j / big_n)
    m[:, 0] = 0.5
    return m


def _zoom_oracle(torch, dev, x32, scaling, scale, vx, vy, vw, vh, trc):
    """A float64 synthesis on the card from the closed-form float64 basis
    and scipy's float64 DCT of the float32 pixels: [vh, vw, C] numpy."""
    import scipy.fft

    from dspfun_tpu_torch.io.color import srgb_encode

    h, w, _ = x32.shape
    c = torch.tensor(scipy.fft.dctn(x32.astype(np.float64), type=2, axes=(0, 1), workers=-1),
                     device=dev)
    yb = _oracle_zoom_basis(torch, dev, scaling, scale, vy, vh, h)
    xb = _oracle_zoom_basis(torch, dev, scaling, scale, vx, vw, w)
    out = torch.matmul(torch.matmul(yb, c.movedim(-1, 0)), xb.T) / float(h * w)
    out = out.movedim(0, -1).cpu().numpy()
    return srgb_encode(out) if trc else out


def _rt_split_sigma(torch, dev, x32, scale, vx, vy, vw, vh):
    """The largest standard deviation, over a frame's outputs, that the
    rounding of zoom's run-time 3-digit route predicts.  Each operand is
    scaled by its slice's power of two 2^e (2^(e-2) <= max < 2^(e-1)) and
    kept to 21 bits, and the kernel drops the digit pairs below 2^-21: per
    term of a contraction three errors, each of variance 2^-42 / 72 in
    scaled units (an operand's residual, uniform in +-2^-22, times the
    other operand taken uniform in +-1/2, which overstates it; two
    dropped pairs of digits uniform in +-64).  K terms add, the first
    contraction's error goes through the second, the frame is divided by
    h w.  Computed from this run's spectrum in float64 on the card."""
    import scipy.fft

    def scale_of(mx):
        return torch.where(mx > 0, torch.exp2(torch.floor(torch.log2(mx)) + 2.0),
                           torch.ones_like(mx))

    h, w, _ = x32.shape
    var_term = 3.0 * 2.0**-42 / 72.0
    c = torch.tensor(scipy.fft.dctn(x32.astype(np.float64), type=2, axes=(0, 1), workers=-1),
                     device=dev).movedim(-1, 0)
    yb = _oracle_zoom_basis(torch, dev, "interpolated", scale, vy, vh, h)
    xb = _oracle_zoom_basis(torch, dev, "interpolated", scale, vx, vw, w)
    c0 = c.clone()
    c0[:, 0, :] = 0.0                               # the route peels the DC row and column
    v1 = (h * var_term * scale_of(yb.abs().amax(1))[None, :, None] ** 2
          * scale_of(c0.abs().amax(1))[:, None, :] ** 2)
    t0 = torch.matmul(yb, c0) + 0.5 * c[:, 0:1, :]
    t0[:, :, 0] = 0.0
    v2 = (torch.matmul(v1, (xb ** 2).T)
          + w * var_term * scale_of(t0.abs().amax(2))[:, :, None] ** 2
          * scale_of(xb.abs().amax(1))[None, None, :] ** 2)
    return float(v2.max().sqrt()) / (h * w)


def _zoom_phase(torch, dev, plain_versions, int8mm, check_i8mm, hw=ZOOM_HW, scale=ZOOM_SCALE,
                pan_frames=ZOOM_PAN_FRAMES, devpan=ZOOM_DEV, small=ZOOM_SMALL) -> dict:
    """Main path 6: the zoom CLI; returns the int8 kernels' launches per
    sub-phase and the 4-digit kernels' stats at the still's shapes."""
    from dspfun_tpu_torch.io import images, video
    from dspfun_tpu_torch.tools import zoom

    h, w = hw
    vh, vw = h * scale, w * scale
    dh, dw = devpan["hw"]
    stats = {}
    for layout, m, k, b, r, what in (("left", vh, h, C, w, "zoom H"), ("right", vw, w, 1, C * vh, "zoom W")):
        stats[f"{layout}4"] = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                                       check_i8mm(4, layout, m, k, b, r, what)))
    # the pan's planned frames (a view of the source's size) and the device
    # pan's run-time-split frames launch the kernels at shapes of their own
    for nd, layout, m, k, b, r, what in ((4, "left", h, h, C, w, "pan H"), (4, "right", w, w, 1, C * h, "pan W"),
                                         (3, "left", dh, dh, C, dw, "devpan H"),
                                         (3, "right", dw, dw, 1, C * dh, "devpan W")):
        check_i8mm(nd, layout, m, k, b, r, what)
    torch.cuda.empty_cache()
    launches = {}
    zoom.TIME_DEVICE = True     # synth_device and pack_device by CUDA events
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoom_") as tmp:
        src = os.path.join(tmp, "in.png")
        _seeded_png(images, src, hw, 21, noise=0.03)
        lin32 = images.read_image(src, linear=True).pixels.astype(np.float32)
        enc32 = images.read_image(src).pixels.astype(np.float32)

        # ---- (a) the 4x still with -g at the default policy (deep i8)
        ref = _zoom_oracle(torch, dev, lin32, "interpolated", scale, 0.0, 0.0, vw, vh, True)
        expect = {"left4": 3, "right4": 1}     # the forward DCT's two, then one of each a frame
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        files = {}
        for tag, ext, force_plain, packer in (("fvid", "fvid", False, True), ("y4m", "y4m", False, True),
                                              ("fvid, plain forced", "fvid", True, True),
                                              ("y4m, no packer", "y4m", False, False)):
            out = os.path.join(tmp, f"still_{len(files)}.{ext}")
            saved = zoom.make_packer
            if not packer:
                zoom.make_packer = lambda *a: None
            try:
                with _policy(None), (plain_versions() if force_plain else contextlib.nullcontext()):
                    wall, st, got = _run_tool(torch, zoom, ["-s", str(scale), "-g", src, out], int8mm)
            finally:
                zoom.make_packer = saved
            if tag == "fvid":
                peak = torch.cuda.max_memory_allocated()
                launches["still"] = got
            if got != ({} if force_plain else expect) or st["routes"] != ["planned"]:
                raise RuntimeError(f"zoom still ({tag}) launched {got} on {st['routes']}, "
                                   f"expected {expect} on the planned route")
            print(f"zoom {w}x{h} -s {scale} -g to {tag}: {wall:.3f} s wall; stages (s) {_stages(st)}; "
                  f"launches {json.dumps(got)}", flush=True)
            files[tag] = out
        err, _ = _frame_rgb_error(video, files["fvid"], 0, ref)
        lv, share = _frame_rgb_error(video, files["y4m"], 0, ref)
        lv2, share2 = _frame_rgb_error(video, files["y4m, no packer"], 0, ref)
        same = open(files["fvid"], "rb").read() == open(files["fvid, plain forced"], "rb").read()
        print(f"zoom still {vw}x{vh}: fvid vs the float64 synthesis (after the OETF) {err:.3e}; y4m "
              f"{lv} level ({share:.6f} off by one), without the packer {lv2} level "
              f"({share2:.6f}); fvid byte-equal kernel vs plain: {same}; peak device memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held before)", flush=True)
        if not (err <= TOOL_TOL and lv <= 1 and lv2 <= 1 and same):
            raise RuntimeError("zoom still failed")
        del ref

        # ---- (b) the pan across the 4x image, to y4m
        out = os.path.join(tmp, "pan.y4m")
        args = ["-s", str(scale), "-v", f"{w}x{h}", "-n", str(pan_frames), "-q",
                "-x", "i/n*(w*xs-vw)", "-y", "(h*ys-vh)/2"]
        pout = os.path.join(tmp, "pan_plain.y4m")
        with _policy(None):
            wall, st, got = _run_tool(torch, zoom, args + [src, out], int8mm)
            with plain_versions():
                pwall, pst, _ = _run_tool(torch, zoom, args + [src, pout], int8mm)
        launches["pan"] = got
        same = open(out, "rb").read() == open(pout, "rb").read()
        worst, share = 0, 0.0
        for f in sorted({0, pan_frames // 2 - 1, pan_frames - 1}):
            ref = _zoom_oracle(torch, dev, enc32, "interpolated", scale,
                               f / pan_frames * (w * scale - w), (h * scale - h) / 2.0, w, h, False)
            e, sh = _frame_rgb_error(video, out, f, ref)
            worst, share = max(worst, e), max(share, sh)
        nplanned = st["routes"].count("planned")
        want = {"left4": 2 + nplanned, "right4": nplanned}
        print(f"zoom pan {w}x{h} view of the {scale}x image, {pan_frames} frames to y4m: "
              f"{pan_frames / wall:.2f} frames/s ({wall:.3f} s); routes {st['routes']}; stages (s) "
              f"{_stages(st)}; launches {json.dumps(got)}; plain forced {pan_frames / pwall:.2f} "
              f"frames/s ({pwall:.3f} s; synthesis {pst['synth_device']:.4f} s); y4m byte-equal kernel "
              f"vs plain: {same}; three frames vs the oracle: {worst} level ({share:.6f} off by one)",
              flush=True)
        if worst > 1 or not same or {k: v for k, v in want.items() if v} != got \
                or pst["routes"] != st["routes"]:
            raise RuntimeError(f"zoom pan failed (launches {got}, expected {want})")

        # ---- (c) a pan on the device basis: default policy and i8@1e-5
        dsrc = os.path.join(tmp, "dev.png")
        _seeded_png(images, dsrc, devpan["hw"], 22, noise=0.03)
        d32 = images.read_image(dsrc).pixels.astype(np.float32)
        n = devpan["frames"]
        args = ["-s", str(devpan["scale"]), "-v", f"{dw}x{dh}", "-n", str(n), "-q",
                "-x", f"{devpan['xstep']}*i", "-y", f"{devpan['ystep']}*i"]
        for name, want in ((None, {"left4": 2}), ("i8@1e-5", {"left3": 2 + n, "right3": n})):
            out = os.path.join(tmp, f"dev_{name}.fvid")
            with _policy(name):
                wall, st, got = _run_tool(torch, zoom, args + [dsrc, out], int8mm)
            launches[f"devpan {name or 'default'}"] = got
            worst, tol = 0.0, TOOL_TOL
            for f in (0, n // 2, n - 1):
                at = (float(devpan["xstep"] * f), float(devpan["ystep"] * f), dw, dh)
                ref = _zoom_oracle(torch, dev, d32, "interpolated", devpan["scale"], *at, False)
                worst = max(worst, _frame_rgb_error(video, out, f, ref)[0])
                if name:
                    tol = max(tol, RT_SPLIT_SIGMAS
                              * _rt_split_sigma(torch, dev, d32, devpan["scale"], *at))
            note = ""
            if name:
                # the run-time split: kernel == plain, byte for byte, over the whole file
                pout = os.path.join(tmp, "dev_plain.fvid")
                with _policy(name), plain_versions():
                    pwall, pst, _ = _run_tool(torch, zoom, args + [dsrc, pout], int8mm)
                same = open(out, "rb").read() == open(pout, "rb").read()
                note = (f"; plain forced {n / pwall:.2f} frames/s ({pwall:.3f} s; synthesis "
                        f"{pst['synth_device']:.4f} s); fvid byte-equal kernel vs plain: {same}; held "
                        f"to {RT_SPLIT_SIGMAS:g} sigma of the split's rounding model, {tol:.3e}")
                if not same or set(pst["routes"]) != {"device"}:
                    raise RuntimeError("zoom device-basis pan: kernel and plain files differ")
            print(f"zoom pan on the device basis, {dw}x{dh} source, {devpan['scale']}x, {dw}x{dh} "
                  f"view, {n} frames to fvid at {name or 'the default policy (deep i8: float32 products)'}: "
                  f"{n / wall:.2f} frames/s ({wall:.3f} s); routes {st['routes']}; stages (s) "
                  f"{_stages(st)}; launches {json.dumps(got)}; three frames vs the oracle {worst:.3e}: "
                  f"the {TOOL_TOL:g} gate {'PASS' if worst <= TOOL_TOL else 'MISS'}{note}", flush=True)
            if set(st["routes"]) != {"device"} or got != want or worst > tol:
                raise RuntimeError(f"zoom device-basis pan at {name} failed (launches {got}, "
                                   f"expected {want}, error {worst}, limit {tol})")

        # ---- (d) showsamples and the other two bases at a small size
        sh_, sw_ = small
        ssrc = os.path.join(tmp, "small.png")
        _seeded_png(images, ssrc, small, 23, noise=0.03)
        s32 = images.read_image(ssrc).pixels.astype(np.float32)
        for extra, scaling in ((["--showsamples=grid"], "interpolated"), (["--basis", "native"], "native"),
                               (["--basis", "centered"], "centered")):
            out = os.path.join(tmp, "small.fvid")
            with _policy(None):
                _run_tool(torch, zoom, ["-s", "3", "-p", "7x5"] + extra + [ssrc, out], int8mm)
            ref = _zoom_oracle(torch, dev, s32, scaling, 3, 7.0, 5.0, 3 * sw_, 3 * sh_, False)
            if extra[0].startswith("--showsamples"):
                # green lines where the input's samples sit: every 3rd row and column
                rows, cols = range(3 - 5 % 3, 3 * sh_, 3), range(3 - 7 % 3, 3 * sw_, 3)
                ref[list(rows), :] = (0.0, 1.0, 0.0)
                ref[:, list(cols)] = (0.0, 1.0, 0.0)
            err = _frame_rgb_error(video, out, 0, ref)[0]
            print(f"zoom {sw_}x{sh_} -s 3 -p 7x5 {' '.join(extra)}: vs the float64 oracle {err:.3e}",
                  flush=True)
            if err > TOOL_TOL:
                raise RuntimeError(f"zoom {extra} failed")
    return {"launches": launches, "stats": stats}


# ---------------------------------------------------------------------------
# phases 11 and 12: the basis tools, rotate and transcode
# ---------------------------------------------------------------------------

BASIS_HW = (128, 128)             # applybasis (a)-(b): a 128x128 image, -u 16x16 (at
                                  # 256x256 each run spent 15 s in the PNG encoder)
BASIS_CROP = 128                  # (c): the DFT on a 128x128 crop
GENBASIS_SIZE = 64                # (d)
DRAW_HW = (2160, 3840)            # (e): draw -b 3840x2160
DRAW_COEFS = [(3, 3, 0.4), (2, 5, 0.2), (4, 6, 0.2)]
# draw's launches at i8@1e-5: the DCT-III along H (left), then along W
# (the [H, W, 1] grid's one column takes the right form on [H, W])
DRAW_I8_EXPECT = {"left3": 1, "right3": 1}
# rotate's two maps of phase 12, as the reference parses them (rotate.c:74-89):
# (axis map, signs), written out here rather than parsed by the tool's code
ROTATIONS = {"y-xz": ([1, 0, 2], [False, True, False]),   # 90 degrees ccw
             "zyx": ([2, 1, 0], [False, False, False])}   # x and t swapped


def _oracle_axis(torch, dev, family, ntiles, ncontent, psum, n_len, ortho, inverse):
    """An applybasis axis matrix from its closed form, on the card in
    float64 (complex128 for the DFT): forward Ah[k, i, s] at sample
    n = i*psum + s, inverse Ch[a, s, i] at sample n = a*psum + s and
    frequency i.  DCT-II: cos(pi k (2n+1) / 2N), times sqrt 2 for k > 0
    when orthogonal; DCT-III: cos(pi n (2i+1) / 2N) for n > 0 (times
    sqrt 2), 1/2 at n = 0 (times 2); DFT: exp(-2 pi i k n / N)."""
    f64 = dict(dtype=torch.float64, device=dev)
    if inverse:
        n = (torch.arange(ntiles, **f64)[:, None] * psum + torch.arange(psum, **f64)[None, :])[:, :, None]
        k = torch.arange(ncontent, **f64)[None, None, :]
        if family != "dct3":
            raise ValueError(family)
        c = torch.where(n > 0, torch.cos(np.pi * n * (2 * k + 1) / (2 * n_len)), torch.full_like(n * k, 0.5))
        return c * torch.where(n > 0, torch.full_like(n, np.sqrt(2.0)), torch.full_like(n, 2.0)) if ortho else c
    k = torch.arange(ntiles, **f64)[:, None, None]
    n = (torch.arange(ncontent, **f64)[:, None] * psum + torch.arange(psum, **f64)[None, :])[None]
    if family == "dft":
        return torch.exp(-2j * np.pi * (k * n).to(torch.complex128) / n_len)
    if family != "dct2":
        raise ValueError(family)
    c = torch.cos(np.pi * k * (2 * n + 1) / (2 * n_len))
    return c * torch.where(k > 0, torch.full_like(k, np.sqrt(2.0)), torch.ones_like(k)) if ortho else c


def _oracle_apply(torch, dev, x, family, psum, ortho, inverse):
    """The float64 oracle of ``apply_basis`` with every term (terms = the
    input's size) on the card: the three-operand sum of the module's
    docstring, on closed-form axis matrices."""
    h, w = x.shape[:2]
    ph, pw = psum
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if inverse:
        mh = _oracle_axis(torch, dev, family, h // ph, h, ph, h, ortho, True)
        mw = _oracle_axis(torch, dev, family, w // pw, w, pw, w, ortho, True)
        p = xd.reshape(h // ph, ph, w // pw, pw, 3)
        if p.is_complex():
            mh, mw = mh.to(p.dtype), mw.to(p.dtype)
        return torch.einsum("asi,asbtz,btj->abijz", mh, p, mw)
    mh = _oracle_axis(torch, dev, family, h, h // ph, ph, h, ortho, False)
    mw = _oracle_axis(torch, dev, family, w, w // pw, pw, w, ortho, False)
    p = xd.reshape(h // ph, ph, w // pw, pw, 3)
    if mh.is_complex() or p.is_complex():
        mh, p, mw = (t.to(torch.complex128) for t in (mh, p, mw))
    return torch.einsum("ais,isjtz,bjt->abijz", mh, p, mw)


def _levels8(png, path):
    arr, _, _ = png.decode_png(open(path, "rb").read())
    return arr.astype(np.int64)


def _basis_phase(torch, dev, plain_versions, int8mm, check_i8mm, hw=BASIS_HW, crop=BASIS_CROP,
                 gsize=GENBASIS_SIZE, draw_hw=DRAW_HW) -> dict:
    """Main path 7: applybasis, genbasis and draw in process; returns the
    int8 kernels' launches of draw at i8@1e-5 and their stats at draw's
    shapes."""
    from dspfun_tpu_torch.io import images, png
    from dspfun_tpu_torch.models import basis_pipeline as bp
    from dspfun_tpu_torch.tools import applybasis, draw, genbasis

    h, w = hw
    captured = {}
    saved_apply, saved_draw = bp.apply_basis, draw.draw_canvas

    def keep_values(*a, **k):
        captured["values"] = saved_apply(*a, **k)
        return captured["values"]

    def keep_canvas(*a, **k):
        captured["canvas"] = saved_draw(*a, **k)
        return captured["canvas"]

    def run(mod, args, policy, force_plain=False):
        """One tool run: (wall s, stage s, int8 launches, peak device bytes
        above what was held before)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _policy(policy), (plain_versions() if force_plain else contextlib.nullcontext()):
            wall, st, got = _run_tool(torch, mod, args, int8mm)
        return wall, st, got, torch.cuda.max_memory_allocated() - base

    def values_vs_oracle(label, ref):
        got = torch.from_numpy(captured.pop("values")).to(dev)
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max()) / scale
        print(f"applybasis {label}: values {tuple(got.shape)} vs the float64 oracle (closed-form "
              f"bases): {err:.3e} of the largest |value| {scale:.6g}", flush=True)
        if not err <= TOOL_TOL:
            raise RuntimeError(f"applybasis {label}: values off the float64 oracle")

    def png_vs_f64(label, a, b):
        la, lb = _levels8(png, a), _levels8(png, b)
        d = np.abs(la - lb)
        print(f"applybasis {label}: PNG {la.shape[1]}x{la.shape[0]} at the default policy vs the "
              f"same run at f64: largest difference {int(d.max())} level, {int((d > 0).sum())} of "
              f"{d.size} samples ({float((d > 0).mean()):.3e}) off by one", flush=True)
        if la.shape != lb.shape or d.max() > 1:
            raise RuntimeError(f"applybasis {label}: default and f64 PNGs differ by more than a level")

    def report(label, wall, st, peak):
        print(f"applybasis {label}: {wall:.3f} s wall; stages (s) {_stages(st)}; peak device "
              f"memory {peak / 2**30:.3f} GiB above what was held", flush=True)

    bp.apply_basis, draw.draw_canvas = keep_values, keep_canvas
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_basis_") as tmp:
            src = os.path.join(tmp, "in.png")
            _seeded_png(images, src, hw, 31)
            shifted = images.read_image(src).pixels * 2 - 1       # the tool's shift2 input

            # ---- (a) the README's progressive loop at 16x its size: -u 16x16
            out = {p: os.path.join(tmp, f"a_{p}.png") for p in ("default", "f64")}
            wall, st, got, peak = run(applybasis, ["-f", "DCT2", "-u", "16x16", src, out["default"]], None)
            report(f"{w}x{h} -f DCT2 -u 16x16 (default policy)", wall, st, peak)
            if got:
                raise RuntimeError(f"applybasis launched {got}")
            values_vs_oracle("-u 16x16", _oracle_apply(torch, dev, shifted, "dct2", (16, 16), False, False))
            wall, st, _, peak = run(applybasis, ["-f", "DCT2", "-u", "16x16", src, out["f64"]], "f64:f64")
            captured.pop("values")
            report("-u 16x16 at f64", wall, st, peak)
            png_vs_f64("-u 16x16", out["default"], out["f64"])
            torch.cuda.empty_cache()

            # ---- (b) the full-sum dump, the full reconstruction and the blocks from it
            dump = os.path.join(tmp, "full.coeff")
            wall, st, _, peak = run(applybasis, ["-fDCT2", "-u", f"{w}x{h}", "-d", dump, src,
                                                 os.path.join(tmp, "full.png")], None)
            report(f"-fDCT2 -u {w}x{h} -d full.coeff", wall, st, peak)
            values_vs_oracle(f"-u {w}x{h} (the dump)",
                             _oracle_apply(torch, dev, shifted, "dct2", (h, w), True, False))
            coeffs, _ = bp.read_coeff_file(dump)
            for u in (f"{w}x{h}", "16x16"):
                ps = (h, w) if u == f"{w}x{h}" else (16, 16)
                inv = {p: os.path.join(tmp, f"inv_{u}_{p}.png") for p in ("default", "f64")}
                args = ["-f", "DCT3", "-I", "-u", u, dump]
                wall, st, _, peak = run(applybasis, args + [inv["default"]], None)
                report(f"-f DCT3 -I -u {u} full.coeff", wall, st, peak)
                values_vs_oracle(f"-I -u {u}", _oracle_apply(torch, dev, coeffs, "dct3", ps, True, True))
                run(applybasis, args + [inv["f64"]], "f64:f64")
                captured.pop("values")
                png_vs_f64(f"-I -u {u}", inv["default"], inv["f64"])
                if u == f"{w}x{h}":
                    back = _levels8(png, inv["default"])[1:-1, 1:-1, :3]
                    d = back - _levels8(png, src)
                    print(f"applybasis full reconstruction {w}x{h} vs the input: largest "
                          f"{int(np.abs(d).max())} level, {float(np.sqrt(np.mean(d * d))):.4f} "
                          f"levels rms", flush=True)
                    if np.abs(d).max() > 1:
                        raise RuntimeError("applybasis: the full reconstruction is off the input")
            del coeffs
            torch.cuda.empty_cache()

            # ---- (c) the complex path, colour handling and -g on a crop
            csrc = os.path.join(tmp, "crop.png")
            images.write_image(csrc, images.read_image(src).pixels[:crop, :crop])
            lin = images.read_image(csrc, linear=True).pixels      # -N hue: no shift2 encoding
            flags = ["-f", "DFT", "-P", "magnitude", "-R", "linearlog", "-N", "hue", "-g",
                     "--bg", "#204080", "-u", "8x8"]
            out = {p: os.path.join(tmp, f"c_{p}.png") for p in ("default", "f64")}
            wall, st, _, peak = run(applybasis, flags + [csrc, out["default"]], None)
            report(f"{crop}x{crop} {' '.join(flags)}", wall, st, peak)
            values_vs_oracle("-f DFT -u 8x8", _oracle_apply(torch, dev, lin, "dft", (8, 8), False, False))
            run(applybasis, flags + [csrc, out["f64"]], "f64:f64")
            captured.pop("values")
            png_vs_f64("-f DFT -P magnitude -R linearlog -N hue -g", out["default"], out["f64"])

            # ---- (d) genbasis: host float64 at any policy
            gflags = ["--function", "DFT", "--size", f"{gsize}x{gsize}", "--natural", "--plane", "complex"]
            gout = [os.path.join(tmp, f"g_{i}.png") for i in range(2)]
            t0 = time.perf_counter()
            with _policy(None):
                if genbasis.main(gflags + [gout[0]]) != 0:
                    raise RuntimeError("genbasis failed")
            gwall = time.perf_counter() - t0
            with _policy("f64:f64"):
                genbasis.main(gflags + [gout[1]])
            lv = _levels8(png, gout[0])
            side = gsize * (gsize + 1) + 1
            same = open(gout[0], "rb").read() == open(gout[1], "rb").read()
            print(f"genbasis {' '.join(gflags)}: {gwall:.3f} s wall, {lv.shape[1]}x{lv.shape[0]} RGBA; "
                  f"default and f64 files byte-equal: {same}", flush=True)
            if lv.shape != (side, side, 4) or not same:
                raise RuntimeError("genbasis failed")

            # ---- (e) draw at 3840x2160: no launch by default, the int8 kernels at i8@1e-5
            dh, dw = draw_hw
            dflags = ["-b", f"{dw}x{dh}"] + sum((["-f", f"{x}x{y}:{s}"] for x, y, s in DRAW_COEFS), [])
            grid = torch.zeros((dh, dw), dtype=torch.float64, device=dev)
            for x, y, s in DRAW_COEFS:
                grid[y, x] = s / 4.0
            grid[0, 0] += 0.5
            ref = _oracle_dct3(torch, dev, dh) @ grid @ _oracle_dct3(torch, dev, dw).T
            del grid
            files, launches = {}, {}
            for tag, policy, plain in (("default", None, False), ("i8@1e-5", "i8@1e-5", False),
                                       ("i8@1e-5, plain forced", "i8@1e-5", True)):
                files[tag] = os.path.join(tmp, f"draw_{len(files)}.png")
                if not plain:
                    int8mm.LAUNCHES.clear()     # the counts start at 0 for each run
                wall, st, got, peak = run(draw, dflags + [files[tag]], policy, force_plain=plain)
                err = float((torch.from_numpy(captured.pop("canvas")).to(dev) - ref).abs().max())
                launches[tag] = got
                print(f"draw {' '.join(dflags)} at {tag}: {wall:.3f} s wall; stages (s) {_stages(st)}; "
                      f"launches {json.dumps(got)}; canvas vs the float64 DCT-III {err:.3e}; peak "
                      f"device memory {peak / 2**30:.3f} GiB above what was held", flush=True)
                if err > TOOL_TOL:
                    raise RuntimeError(f"draw at {tag}: the canvas is off the float64 DCT-III")
            same = open(files["i8@1e-5"], "rb").read() == open(files["i8@1e-5, plain forced"], "rb").read()
            d = np.abs(_levels8(png, files["i8@1e-5"]) - _levels8(png, files["default"]))
            print(f"draw at i8@1e-5: file byte-equal kernel vs plain: {same}; vs the default "
                  f"policy's file {int(d.max())} level", flush=True)
            if launches["default"] or launches["i8@1e-5"] != DRAW_I8_EXPECT or not same or d.max() > 1:
                raise RuntimeError(f"draw failed (launches {launches}, expected {DRAW_I8_EXPECT})")
    finally:
        bp.apply_basis, draw.draw_canvas = saved_apply, saved_draw

    # the kernels at draw's shapes, and the second contraction's two forms
    torch.cuda.empty_cache()
    stats = {"left3 H": check_i8mm(3, "left", dh, dh, 1, dw, "draw H"),
             "left3 W": check_i8mm(3, "left", dw, dw, dh, 1, "draw W left R=1"),
             "right3 W": check_i8mm(3, "right", dw, dw, 1, dh, "draw W right")}
    _draw_forms(torch, dev, int8mm, dh, dw)
    torch.cuda.empty_cache()
    return {"launches": launches["i8@1e-5"], "stats": stats}


def _draw_forms(torch, dev, int8mm, h, w) -> None:
    """draw's second contraction (DCT-III along W of the [H, W, 1] grid) in
    the batched left form with one column and in the right form on the
    [H, W] grid: both split x per row over K, so the digits, the kernel's
    groups and the scales are the same; prints whether the two are
    bit-equal and each one's time (split, kernel and scales)."""
    from dspfun_tpu_torch.core.basis import dct3_matrix

    a, sa = (torch.from_numpy(t).to(dev) for t in int8mm.split_matrix_i8(dct3_matrix(w), 3))
    x = torch.randn((h, w), generator=torch.Generator(device=dev).manual_seed(5), device=dev)

    def left():
        xd, ex = int8mm._split_operand(x[:, :, None], 1, 3)
        return int8mm._i8_groups(a, xd, "left") * ex * sa[None]

    def right():
        xd, ex = int8mm._split_operand(x[None], 2, 3)
        return (int8mm._i8_groups(a, xd, "right")[0] * ex[0] * sa[:, 0][None, :])[:, :, None]

    same = torch.equal(left(), right())
    ms = {f: cuda_ms(fn) for f, fn in (("left", left), ("right", right))}
    print(f"draw W contraction M=K={w} over {h} rows: batched left form (R=1) {ms['left']:.4f} ms, "
          f"right form {ms['right']:.4f} ms (split, kernel, scales); bit-equal: {same}", flush=True)
    if not same:
        raise RuntimeError("draw's two forms of the W contraction differ")


def _rotate_oracle_frame(vol, axmap, inv, t):
    """Frame ``t`` of the rotated [T, H, W, C] volume by the reference's
    index map (rotate.c:159-172): output position (a0, a1, a2) along
    (x', y', t') takes source axis map[k] = a_k, and source axis i is
    read backwards when inv[map[i]]."""
    lens = [vol.shape[2], vol.shape[1], vol.shape[0]]
    a1, a0 = np.mgrid[0:lens[axmap[1]], 0:lens[axmap[0]]]
    axis = [None] * 3
    axis[axmap[0]], axis[axmap[1]], axis[axmap[2]] = a0, a1, np.full_like(a0, t)
    idx = [lens[i] - axis[i] - 1 if inv[axmap[i]] else axis[i] for i in range(3)]
    return vol[idx[2], idx[1], idx[0]]


ROTATE_FRAMES = 8                 # phase 12's depth: the first 8 frames of phase 6's
                                  # clip (all 48 took 66 s of host work)


def _rotate_phase(torch, int8mm, nframes=ROTATE_FRAMES) -> None:
    """Main path 8: rotate and transcode on the first ``nframes`` frames of
    phase 6's 1080p 4:2:0 clip (host work in both packages: no kernel may
    launch)."""
    from dspfun_tpu_torch.io import video
    from dspfun_tpu_torch.tools import rotate, transcode

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rotate_") as tmp:
        clip = os.path.join(tmp, "clip.y4m")
        _write_clip(video, clip, nframes)
        r = video.open_input(clip)
        vol = np.stack([r.read_frame_rgb() for _ in range(nframes)])   # the clip as decoded RGB
        r.close()
        for spec, (axmap, inv) in ROTATIONS.items():
            out = os.path.join(tmp, f"rot_{spec}.y4m")
            wall, st, got = _run_tool(torch, rotate, ["-q", spec, clip, out], int8mm)
            r = video.open_input(out)
            frames, pf = r.frames, r.pix_fmt
            t = 0
            while (planes := r.read_frame(raw=True)) is not None:
                want = video.rgb_to_planes(_rotate_oracle_frame(vol, axmap, inv, t), pf, r.props)
                for i, (p, q) in enumerate(zip(planes, want)):
                    if not np.array_equal(p, video._quantize_plane(q, pf, i, r.props.color_range)):
                        raise RuntimeError(f"rotate {spec}: frame {t} plane {i} is off the index map")
                t += 1
            r.close()
            print(f"rotate {spec} of {MW}x{MH} yuv420p, {len(vol)} frames: {frames} frames of "
                  f"{r.width}x{r.height} {pf.name} in {wall:.3f} s; stages (s) {_stages(st)}; "
                  f"every pel equal to the index-map oracle", flush=True)
            if t != frames or frames != vol.shape[[2, 1, 0][axmap[2]]] or got:
                raise RuntimeError(f"rotate {spec}: {t} frames, launches {got}")
        del vol
        mid, back = os.path.join(tmp, "mid.fvid"), os.path.join(tmp, "back.y4m")
        w1, _, got1 = _run_tool(torch, transcode, ["-q", clip, mid], int8mm)
        w2, _, got2 = _run_tool(torch, transcode, ["-q", "-c", "pixel_format=yuv420p", mid, back],
                                int8mm)
        same = open(back, "rb").read() == open(clip, "rb").read()
        print(f"transcode y4m -> fvid {w1:.3f} s ({os.path.getsize(mid)} bytes), fvid -> y4m "
              f"{w2:.3f} s; round trip byte-equal: {same}", flush=True)
        if not same or got1 or got2:
            raise RuntimeError("transcode y4m -> fvid -> y4m changed the clip or launched a kernel")


# ---------------------------------------------------------------------------
# phase 13: motion's --eval, FFV1-in-NUT and Matroska, --resume-file
# ---------------------------------------------------------------------------

FADE = "c * ((width-x)/width) * ((height-y)/height) * ((depth-z)/depth)"
FADE_SHARE = 1e-3                 # pels off by one level against the float64 oracle
STATEFUL = "c*(1+0.1*random(0))"
STATEFUL_CROP = dict(hw=(48, 64), frames=4)


class _Interrupted(Exception):
    """Raised by phase 13(d) to cut a run after a given number of slabs."""


def _fade_oracle(planes, fft) -> list:
    """motion -b 0x0x0 --eval FADE in float64: per plane, the whole clip's
    DCT-II, each coefficient times ((w-x)/w)((h-y)/h)((d-z)/d), the
    DCT-III / (8 d h w), then floor(x + 0.5) clipped to 0..255 (the
    uniform renorm and its inverse cancel on a linear expression)."""
    out = []
    for p in planes:
        d, h, w = p.shape
        f = fft.dctn(p.astype(np.float64), type=2, workers=-1)
        f *= ((d - np.arange(d)) / d)[:, None, None]
        f *= ((h - np.arange(h)) / h)[None, :, None]
        f *= ((w - np.arange(w)) / w)[None, None, :]
        y = fft.dctn(f, type=3, workers=-1)
        y /= 8.0 * d * h * w
        out.append(np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8))
        del f, y
    return out


def _decode_planes(video, path, nframes=None):
    """[T, h, w] stored planes of a clip and the reader's class name."""
    r = video.open_input(path)
    kind, frames = type(r).__name__, []
    while (f := r.read_frame(raw=True)) is not None:
        frames.append(f)
    r.close()
    if nframes is not None and len(frames) != nframes:
        raise RuntimeError(f"{path}: {len(frames)} frames, expected {nframes}")
    return [np.stack([f[i] for f in frames]) for i in range(len(frames[0]))], kind


def _busy_ms(torch, fn):
    """(result, device busy ms, device events) of one call under
    torch.profiler: the union of the kernel and copy spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, reach = 0.0, spans[0][0] if spans else 0.0
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return res, busy / 1e3, len(spans)


def _eval_phase(torch, dev, plain_versions, int8mm, block_filter, check_i8mm, fft,
                hw=(MH, MW), frames=MFRAMES, crop=STATEFUL_CROP) -> dict:
    """Main path 9: motion's --eval at full width, a stateful expression,
    FFV1-in-NUT and Matroska outputs of phase 6's lowpass, and
    --resume-file.  Returns the kernels' launches over the path."""
    from dspfun_tpu_torch.io import video
    from dspfun_tpu_torch.models import motion_pipeline as mp
    from dspfun_tpu_torch.tools import motion

    global MH, MW, MFRAMES
    saved_dims = (MH, MW, MFRAMES)
    MH, MW, MFRAMES = hw[0], hw[1], frames
    launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
            clip = os.path.join(tmp, "clip.y4m")
            src = _write_clip(video, clip)

            def run(args, dst, extra=()):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                rc = motion.main(["-Q", *extra, *args, clip, dst])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise RuntimeError(f"motion {args} -> {dst} exited {rc}")
                peak = (torch.cuda.max_memory_allocated() - base) / 2**30
                return wall, dict(motion.LAST_STAGE_TIMES), peak

            # ---- (a) the README's fade over the whole clip, one block a plane
            t0 = time.perf_counter()
            oracle = _fade_oracle(src, fft)
            print(f"phase 13a float64 oracle: {time.perf_counter() - t0:.1f} s", flush=True)
            fade = ["-b", "0x0x0", "--eval", FADE]
            files = {}
            for label, policy in (("default", None), ("i8@1e-5", "i8@1e-5")):
                out = os.path.join(tmp, f"fade_{label}.nut")
                seen = []
                real_groups = int8mm._i8_groups

                def spy(a, x, layout, real=real_groups):
                    seen.append((layout, tuple(a.shape), tuple(x.shape)))
                    return real(a, x, layout)

                int8mm.LAUNCHES.clear()
                block_filter.LAUNCHES.clear()
                int8mm._i8_groups = spy
                try:
                    with _policy(policy):
                        (wall, st, peak), busy, events = _busy_ms(torch, lambda: run(fade, out))
                finally:
                    int8mm._i8_groups = real_groups
                got = {n: c for n, c in {**int8mm.LAUNCHES, **block_filter.LAUNCHES}.items() if c}
                planes, kind = _decode_planes(video, out, frames)
                files[label] = out
                total = off = 0
                for i, (p, q) in enumerate(zip(planes, oracle)):
                    diff = np.abs(p.astype(np.int16) - q.astype(np.int16))
                    total, off = total + diff.size, off + int((diff > 0).sum())
                    print(f"fade {label} plane {i} {p.shape}: max |pel - f64 oracle| "
                          f"{int(diff.max())}, off by one {np.mean(diff > 0):.6f}", flush=True)
                    if diff.max() > 1:
                        raise RuntimeError(f"fade {label} plane {i} is {diff.max()} levels "
                                           "from the float64 oracle")
                shapes = sorted(set(seen))
                print(f"fade {label} ({kind}, {frames} frames of {hw[1]}x{hw[0]} 4:2:0): "
                      f"{wall:.3f} s wall, stages (s) {_stages(st)}, device busy {busy:.1f} ms "
                      f"({events} device events), peak device memory {peak:.3f} GiB, "
                      f"launches {json.dumps(got)}, int8 forms {shapes}; off by one "
                      f"{off / total:.6f} of {total} pels ({'PASS' if off / total < FADE_SHARE else 'MISS'} "
                      f"< {FADE_SHARE})", flush=True)
                if off / total >= FADE_SHARE and label == "default":
                    # i8@1e-5 splits the whole clip's coefficients, whose
                    # range the DC sets, into 3 digits: printed, not gated
                    raise RuntimeError(f"fade {label}: {off / total:.6f} of the pels are off "
                                       f"by one (limit {FADE_SHARE})")
                if label == "default" and got:
                    raise RuntimeError(f"the default policy's fade launched {got}")
                if label == "i8@1e-5":
                    if not (got.get("left3") and got.get("right3")):
                        raise RuntimeError(f"fade at i8@1e-5 launched {got}, not left3 and right3")
                    launches.update(got)
                    fade_forms = shapes
            out_plain = os.path.join(tmp, "fade_plain.nut")
            with _policy("i8@1e-5"), plain_versions():
                wall_plain, _, _ = run(fade, out_plain)
            same = open(out_plain, "rb").read() == open(files["i8@1e-5"], "rb").read()
            print(f"fade i8@1e-5 plain forced: {wall_plain:.3f} s; file byte-equal to the "
                  f"kernels' run: {same}", flush=True)
            if not same:
                raise RuntimeError("fade at i8@1e-5: the kernels' file differs from plain forced")
            del oracle
            for layout, ashape, xshape in fade_forms:
                nd, m, _ = ashape
                _, b, d1, d2 = xshape
                k, r = (d1, d2) if layout == "left" else (d2, d1)
                check_i8mm(nd, layout, m, k, b, r, f"fade {layout} M={m}")
            torch.cuda.empty_cache()

            # ---- (b) a stateful expression on a crop, card against CPU
            (ch, cw), cn = crop["hw"], crop["frames"]
            small = os.path.join(tmp, "crop.y4m")
            w = video.open_output(small, cw, ch, Fraction(25, 1), video.ColorProps(pix_fmt="yuv420p"))
            for t in range(cn):
                w.write_frame([p[t, : (ch if i == 0 else ch // 2), : (cw if i == 0 else cw // 2)]
                               for i, p in enumerate(src)], raw=True)
            w.close()
            parsed, real_parse = [], motion.parse_expr
            motion.parse_expr = lambda *a: parsed.append(real_parse(*a)) or parsed[-1]
            res = {}
            try:
                for d in ("cuda", "cpu"):
                    out = os.path.join(tmp, f"stateful_{d}.y4m")
                    t0 = time.perf_counter()
                    if motion.main(["-Q", "--device", d, "-b", "8x8x2", "--eval", STATEFUL,
                                    small, out]) != 0:
                        raise RuntimeError(f"stateful --eval on {d} failed")
                    res[d] = (time.perf_counter() - t0, dict(motion.LAST_STAGE_TIMES),
                              _decode_planes(video, out, cn)[0])
            finally:
                motion.parse_expr = real_parse
            (wa, sa, pa), (wb, _, pb) = res["cuda"], res["cpu"]
            same_state = (parsed[0]._slots == parsed[1]._slots and parsed[0]._prng == parsed[1]._prng
                          and bool(parsed[0]._slots))
            worst = max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(pa, pb))
            print(f"stateful --eval '{STATEFUL}' on {cw}x{ch}x{cn}: card {wa:.3f} s (host "
                  f"round trip {sa['host_eval']:.3f} s, {100 * sa['host_eval'] / wa:.1f} % of the "
                  f"wall), cpu {wb:.3f} s; slots and generators equal: {same_state} "
                  f"({parsed[0]._slots}); max |card - cpu| {worst} level", flush=True)
            if not same_state or worst > 1:
                raise RuntimeError("stateful --eval: the card's run differs from the CPU's")

            # ---- (c) phase 6's lowpass into FFV1-in-NUT and Matroska
            if not isinstance(video.open_input(clip), video.NativeBackedReader):
                raise RuntimeError("the y4m clip did not open through NativeBackedReader")
            ref_y4m = os.path.join(tmp, "low.y4m")
            _, st_y4m, _ = run(MOTION_ARGS[1:], ref_y4m)
            real_open = video.open_input
            video.open_input = lambda spec, format=None, options=None: real_open(
                spec, format, native=False, options=options)
            try:
                _, st_py, _ = run(MOTION_ARGS[1:], ref_y4m)
            finally:
                video.open_input = real_open
            ref = _decode_planes(video, ref_y4m, frames)[0]
            int8mm.LAUNCHES.clear()
            block_filter.LAUNCHES.clear()
            for ext in ("nut", "mkv"):
                out = os.path.join(tmp, f"low.{ext}")
                wall, st, _ = run(MOTION_ARGS[1:], out)
                planes, kind = _decode_planes(video, out, frames)
                equal = all(np.array_equal(a, b) for a, b in zip(planes, ref))
                print(f"motion lowpass to .{ext} ({kind}, FFV1): {wall:.3f} s, stages (s) "
                      f"{_stages(st)}; write {st['write']:.3f} s against y4m's "
                      f"{st_y4m['write']:.3f} s; {os.path.getsize(out)} bytes against "
                      f"{os.path.getsize(ref_y4m)}; frames equal to the y4m run's: {equal}; "
                      f"fast path {mp.LAST_FAST_PATH}", flush=True)
                if not equal or mp.LAST_FAST_PATH != "cuda-kron":
                    raise RuntimeError(f"motion lowpass to .{ext} differs from y4m or left cuda-kron")
            print(f"motion lowpass read: {st_y4m['read']:.3f} s through NativeBackedReader, "
                  f"{st_py['read']:.3f} s through the Python y4m reader", flush=True)
            for n, c in {**int8mm.LAUNCHES, **block_filter.LAUNCHES}.items():
                launches[n] = launches.get(n, 0) + c
            if not launches.get("block_filter"):
                raise RuntimeError("kernel #3 never launched on the lowpass into NUT and MKV")

            # ---- (d) --resume-file: cut after one slab, finish with the same flags
            part, state = os.path.join(tmp, "part.nut"), os.path.join(tmp, "state.json")
            real_filter, calls = mp.filter_blocks, []

            def cut(*a, **k):
                calls.append(1)
                if len(calls) > 3:                  # three planes a slab: stop in slab 2
                    raise _Interrupted
                return real_filter(*a, **k)

            mp.filter_blocks = cut
            try:
                run(MOTION_ARGS[1:], part, ("--resume-file", state))
                raise RuntimeError("the interrupted run was not interrupted")
            except _Interrupted:
                pass
            finally:
                mp.filter_blocks = real_filter
            done = json.load(open(state))["slab"]
            wall, _, _ = run(MOTION_ARGS[1:], part, ("--resume-file", state))
            planes, _ = _decode_planes(video, part, frames)
            equal = all(np.array_equal(a, b) for a, b in zip(planes, ref))
            print(f"motion --resume-file: cut after {done} slab(s), resumed to "
                  f"{json.load(open(state))['slab']} in {wall:.3f} s; frames equal to one "
                  f"uninterrupted run: {equal}", flush=True)
            if done != 1 or not equal:
                raise RuntimeError("--resume-file did not reproduce the uninterrupted run")
    finally:
        MH, MW, MFRAMES = saved_dims
    return launches


# phase 14: the device mesh (ranks over torch.distributed) -------------------
MESH_RANKS = (2, 4)               # ranks that share the card, over gloo
MESH_SCAN = dict(hw=(256, 256), step=16, frames=128)
MESH_ZOOM_SCALE = 4
# motion's volume route: the whole clip as one block, a quarter lowpass
# box boosted, the rest damped, the DC kept (filter_blocks' general chain
# on the single device too)
MESH_VOLUME = dict(bp_end=(480, 270, 12), boost=1.25, damp=0.5, preserve_dc="dc")
# the JAX package's own mesh tolerances (tests/test_spec_sharded.py,
# tests/test_mesh_cli.py): spec forward 3e-5 and inverse 1e-4, scan 1e-5
# (1e-4 on i8 plans), zoom 2e-5, the volume 1e-5 of the pel range; the
# block route bit-equal
MESH_TOL = {"spec_forward": 3e-5, "spec_inverse": 1e-4, "scan": 1e-4, "zoom": 2e-5,
            "volume": 1e-5 * 255.0, "blocks": 0.0}
MESH_BUDGET_S = 120.0


def _mesh_rank_begin(torch, dev):
    """Per-task state of a rank: counts at zero, peak memory reset."""
    from dspfun_tpu_torch.ops import block_filter, int8mm
    from dspfun_tpu_torch.parallel import mesh as pm

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    int8mm.LAUNCHES.clear()
    block_filter.LAUNCHES.clear()
    pm.COUNTS.clear()
    pm.SECONDS.clear()


def _mesh_rank_end(torch, dev, t0, stages):
    """What every rank returns: its launches, collectives, seconds by
    stage, wall, collective seconds and peak device memory."""
    from dspfun_tpu_torch.ops import block_filter, int8mm
    from dspfun_tpu_torch.parallel import mesh as pm

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {n: c for n, c in {**int8mm.LAUNCHES, **block_filter.LAUNCHES}.items() if c}
    return {"launches": launches, "collectives": dict(pm.COUNTS), "stages": stages,
            "wall_s": time.perf_counter() - t0, "collective_s": float(sum(pm.SECONDS.values())),
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if dev.type == "cuda" else None)}


def _mesh_timed(torch, dev, stages, name, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
    return out


def _mesh_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _mesh_run(mesh, case, inputs, policy, small):
    """A rank's task: one tool's sharded function, twice (the first call
    builds its plans), the second with the counts at zero, its stages
    timed and the collectives synchronised; then every rank gathers the
    output and rank 0 holds it to the single-device port on the same
    device.  Returns the readings (rank 0: with the errors); the case
    function runs the path and returns the check that gathers and
    compares, which the readings leave out."""
    import torch

    from dspfun_tpu_torch.core.precision import Precision
    from dspfun_tpu_torch.parallel import mesh as pm

    dev = mesh.device
    p = Precision() if policy is None else Precision.parse(policy)
    fn = {"spec": _mesh_spec, "volume": _mesh_volume, "blocks": _mesh_blocks,
          "scan": _mesh_scan, "zoom": _mesh_zoom}[case]
    if not small:                      # the small inputs of (b) check wiring, not times
        fn(torch, mesh, dev, inputs, p, small, None)        # cold: plans, caches
    _mesh_rank_begin(torch, dev)
    pm.SYNC_TIMING = True
    stages: dict = {}
    t0 = time.perf_counter()
    try:
        check = fn(torch, mesh, dev, inputs, p, small, stages)
    finally:
        pm.SYNC_TIMING = False
    res = _mesh_rank_end(torch, dev, t0, stages)
    res["errors"] = check()
    return res


def _mesh_inputs(inputs, small):
    img = np.load(inputs["image"], mmap_mode="r")
    planes = [np.load(path, mmap_mode="r") for path in inputs["planes"]]
    if small:
        img = img[:256, :384]
        planes = [pl[:16, : 144 >> (i > 0), : 256 >> (i > 0)] for i, pl in enumerate(planes)]
    return np.array(img), [np.array(pl) for pl in planes]


def _mesh_spec(torch, mesh, dev, inputs, p, small, stages):
    """spec -t flat forward then inverse over 'space' (rows, then columns)."""
    from dspfun_tpu_torch.models.spec_pipeline import SpecChainParams, spec_forward, spec_inverse
    from dspfun_tpu_torch.parallel import spec_sharded as ss

    img, _ = _mesh_inputs(inputs, small)
    x = torch.from_numpy(img).to(dev)
    params = SpecChainParams.template("flat")
    st = {} if stages is None else stages
    xs = ss.image_sharding(mesh)(x)
    f, dc = _mesh_timed(torch, dev, st, "forward",
                        lambda: ss.spec_forward_sharded(xs, params, mesh, p))
    y = _mesh_timed(torch, dev, st, "inverse",
                    lambda: ss.spec_inverse_sharded(f, params, mesh, dc=dc, precision=p))

    def check():
        f_all = ss.spectrum_sharding(mesh).gather(f)
        y_all = ss.image_sharding(mesh).gather(y)
        if mesh.rank:
            return None
        t1 = {}
        rf, rdc = _mesh_timed(torch, dev, t1, "s", lambda: spec_forward(x, params, p))
        ry = _mesh_timed(torch, dev, t1, "s", lambda: spec_inverse(rf, params, dc=rdc,
                                                                     precision=p))
        return {"spec_forward": _mesh_err(f_all, rf), "dc": _mesh_err(dc, rdc),
                "spec_inverse": _mesh_err(y_all, ry), "round_trip": _mesh_err(y_all, x),
                "one_device_s": t1["s"]}
    return check


def _mesh_geoms(mp, planes, block, bp_end):
    t, h, w = planes[0].shape
    return mp.plan_geometry(w, h, t, 3, 1, 1, block=mp.Dims(*block), bp_end=mp.Dims(*bp_end))


def _mesh_volume(torch, mesh, dev, inputs, p, small, stages):
    """motion's whole-clip volume chain (-b 0x0x0) on every plane."""
    from dspfun_tpu_torch.models import motion_pipeline as mp
    from dspfun_tpu_torch.parallel import motion_sharded as msh

    _, planes = _mesh_inputs(inputs, small)
    bp = MESH_VOLUME["bp_end"]
    if small:
        bp = (bp[0] * 256 // MW, bp[1] * 144 // MH, 4)
    geoms = _mesh_geoms(mp, planes, (0, 0, 0), bp)
    params = mp.MotionParams(boost=MESH_VOLUME["boost"], damp=MESH_VOLUME["damp"],
                             preserve_dc=MESH_VOLUME["preserve_dc"], float_pixels=True)
    vs = msh.volume_sharding(mesh)
    st = {} if stages is None else stages
    outs = []
    for i, g in enumerate(geoms):
        shard = torch.from_numpy(np.ascontiguousarray(vs(planes[i]))).to(dev)
        out, _ = _mesh_timed(torch, dev, st, f"plane{i}", lambda: msh.motion_filter_volume_sharded(
            shard, mesh, geom=g, params=params, plane_index=i, nplanes=3, precision=p))
        outs.append(out)

    def check():
        full = [vs.gather(o) for o in outs]
        if mesh.rank:
            return None
        err, t1 = 0.0, {}
        for i, g in enumerate(geoms):
            vol = torch.from_numpy(planes[i]).to(dev)[None]
            plans = mp.make_plans(g, p, dev)
            ref, _ = _mesh_timed(torch, dev, t1, "s", lambda: mp.filter_blocks(
                vol, plans, None, 0, geom=g, params=params, plane_index=i, nplanes=3))
            err = max(err, _mesh_err(full[i], ref[0]))
            del ref
        return {"volume": err, "one_device_s": t1["s"]}
    return check


def _mesh_blocks(torch, mesh, dev, inputs, p, small, stages):
    """motion's block route (phase 6's lowpass), slab by slab over 'space'."""
    from dspfun_tpu_torch.models import motion_pipeline as mp
    from dspfun_tpu_torch.parallel.sharded import shard_blocks_filter

    _, planes = _mesh_inputs(inputs, small)
    geoms = _mesh_geoms(mp, planes, (16, 16, 16), (8, 8, 4))
    params = mp.MotionParams(boost=1.25, damp=0.0, float_pixels=False)
    plans = [(*mp.make_plans(g, p, dev), mp.maybe_kron_plans(g, params, device=dev))
             for g in geoms]
    st = {} if stages is None else stages
    outs = []
    for bz in range(planes[0].shape[0] // 16):
        for i, g in enumerate(geoms):
            blocks = mp.frames_to_blocks(
                torch.from_numpy(planes[i][16 * bz:16 * (bz + 1)]).to(dev), g).contiguous()
            out, _ = _mesh_timed(torch, dev, st, f"plane{i}", lambda: shard_blocks_filter(
                blocks, plans[i], None, bz, mesh, geom=g, params=params, plane_index=i,
                nplanes=3))
            outs.append((out, blocks, i, bz))

    def check():
        if mesh.rank:
            return None
        err, t1 = 0.0, {}
        for out, blocks, i, bz in outs:
            ref, _ = _mesh_timed(torch, dev, t1, "s", lambda: mp.filter_blocks(
                blocks, plans[i], None, bz, geom=geoms[i], params=params, plane_index=i,
                nplanes=3))
            err = max(err, _mesh_err(out, ref))
        return {"blocks": err, "one_device_s": t1["s"]}
    return check


def _mesh_scan(torch, mesh, dev, inputs, p, small, stages):
    """scan's 256x256 zigzag chunks with parity, rows over 'space'."""
    from dspfun_tpu_torch.models import scan_pipeline as sp
    from dspfun_tpu_torch.ops import scan_methods as sm

    img, _ = _mesh_inputs(inputs, False)
    h, w = MESH_SCAN["hw"]
    x = np.ascontiguousarray(img[:h, :w]).astype(np.float64)
    order = sm.get_method("zigzag").build(w, h)
    coeffs = sp.forward_coeffs(x, p, dev)
    plan = sp.plan_scan(order, w, h, 3, step=MESH_SCAN["step"], nframes=MESH_SCAN["frames"],
                        chunk=32, precision=p, device=dev)

    def collect(mesh_arg):
        sums, parity = [], []
        for _, res in sp.scan_chunks(plan, coeffs, orig=x, parity_depth=8, mesh=mesh_arg):
            sums.append(res.sums)
            parity.append(res.parity)
        return np.concatenate(sums), np.concatenate(parity)

    st = {} if stages is None else stages
    got, parity = _mesh_timed(torch, dev, st, "chunks", lambda: collect(mesh))

    def check():
        if mesh.rank:
            return None
        t1 = {}
        ref, rparity = _mesh_timed(torch, dev, t1, "s", lambda: collect(None))
        return {"scan": float(np.max(np.abs(got - ref))),
                "parity_equal": bool(np.array_equal(parity, rparity)), "one_device_s": t1["s"]}
    return check


def _mesh_zoom(torch, mesh, dev, inputs, p, small, stages):
    """zoom's 4x still of 1080p (-g), the planned route, rows over 'space'."""
    from dspfun_tpu_torch.models import zoom_pipeline as zp

    img, _ = _mesh_inputs(inputs, False)
    h, w = (270, 480) if small else (MH, MW)
    x = np.ascontiguousarray(img[:h, :w]).astype(np.float64)
    spec = zp.forward_spectrum(x, p, dev)
    s = MESH_ZOOM_SCALE
    args = ("interpolated", (s, 1.0), (s, 1.0), 0.0, 0.0, w * s, h * s)
    st = {} if stages is None else stages
    out = _mesh_timed(torch, dev, st, "frame", lambda: zp.zoom_frame(
        spec, *args, precision=p, encode_trc=True, mesh=mesh))

    def check():
        if mesh.rank:
            return None
        t1 = {}
        ref = _mesh_timed(torch, dev, t1, "s", lambda: zp.zoom_frame(
            spec, *args, precision=p, encode_trc=True))
        return {"zoom": _mesh_err(out, ref), "one_device_s": t1["s"]}
    return check


# one rank's shard of each kernel's contraction on the mesh path at two
# ranks: (digits, layout, M, K, B, R, what)
MESH_SHARD_SHAPES = [
    (3, "right", W, W, 1, C * H // 2, "spec W shard"),
    (3, "left", H, H, C, W // 2, "spec H shard"),
    (3, "right", 256, 4096, 1, MOTION_NB // 2, "motion fwd shard"),
    (3, "right", 4096, 256, 1, MOTION_NB // 2, "motion inv shard"),
    (4, "left", 2 * MH, MH, C, MW, "zoom H shard"),
    (4, "right", 4 * MW, MW, 1, C * 2 * MH, "zoom W shard"),
]


def _mesh_main(torch, dev, check_i8mm, block_filter, fft) -> dict:
    """Phase 14: (d) the kernels against their plain versions at one
    rank's shard shapes, (a)-(b) the sharded paths on ranks that share the
    card and over nccl, (c) the CLIs' mesh on this machine's cards."""
    from dspfun_tpu_torch.io import images, video

    t0 = time.perf_counter()
    stats: dict = {}
    for nd, layout, m, k, b, r, what in MESH_SHARD_SHAPES:
        res = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                       check_i8mm(nd, layout, m, k, b, r, what)))
        stats.setdefault(f"{layout}{nd}", {})[what] = res
    torch.cuda.empty_cache()
    stats["block_filter"] = _check_block_filter(
        torch, dev, block_filter, fft,
        shapes=(("chroma 1080p shard", MOTION_NB // 2, (16, 8, 8)),))
    stats["block_filter"].pop("ms_by_shape", None)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        # the clip as a file only where (c) runs the CLIs on it (two cards)
        clip = os.path.join(tmp, "clip.y4m")
        planes = _write_clip(video, clip if torch.cuda.device_count() > 1 else None)
        rng = np.random.default_rng(14)
        yy, xx = np.mgrid[0:H, 0:W] / float(max(H, W))
        img = np.stack([0.5 + 0.3 * np.sin(9 * xx + c) * np.cos(7 * yy - c) for c in range(C)], -1)
        img = (img + 0.05 * rng.standard_normal(img.shape)).astype(np.float32)
        inputs = {"image": os.path.join(tmp, "image.npy"),
                  "planes": [os.path.join(tmp, f"plane{i}.npy") for i in range(3)]}
        np.save(inputs["image"], img)
        for path, pl in zip(inputs["planes"], planes):
            np.save(path, pl)
        del img, planes
        print(f"phase 14 inputs and shard-shape kernel checks: {time.perf_counter() - t0:.1f} s",
              flush=True)
        out = _mesh_phase(torch, dev, inputs)
        png = os.path.join(tmp, "small.png")
        images.write_image(png, rng.random((64, 96, 3)))
        _mesh_cli_phase(torch, video, images, clip, png)
    wall = time.perf_counter() - t0
    note = "" if wall <= MESH_BUDGET_S else f" (over the {MESH_BUDGET_S:.0f} s budget)"
    print(f"phase 14 {wall:.1f} s{note}", flush=True)
    need = [f"{layout}{nd}" for nd, layout, *_ in MESH_SHARD_SHAPES] + ["block_filter"]
    missing = [n for n in need if not out["launches"].get(n)]
    if missing:
        raise RuntimeError(f"mesh path: kernels {missing} never launched on a rank")
    out["shard_stats"] = {n: st for n, st in stats.items()}
    return out


MESH_CASES = [  # (case, policy, what it runs, at how many ranks)
    ("spec", None, "spec -t flat 3840x2160 RGB, default policy (exact)", (1, 2)),
    ("spec", "i8@1e-5", "spec -t flat 3840x2160 RGB at i8@1e-5", (1, 2, 4)),
    ("volume", None, "motion -b 0x0x0 on the 1080p 4:2:0 clip, 48 frames", (1, 2, 4)),
    ("blocks", None, "motion -b 16x16x16 lowpass on the 1080p 4:2:0 clip", (1, 2, 4)),
    ("scan", "i8@1e-5", "scan 256x256 zigzag -S 16, 128 frames, at i8@1e-5", (1, 2, 4)),
    ("zoom", "i8", "zoom -s 4 -g still of 1080p, deep i8 (the card's default)", (1, 2, 4)),
]


def _mesh_meshes(pool, ranks):
    """The meshes of each case at ``ranks`` ranks: the volume over
    space=2,time=2 at four ranks, everything else over 'space'."""
    return {case: (pool.mesh(space=ranks // 2, time=2) if case == "volume" and ranks == 4
                   else pool.mesh(space=ranks)) for case, *_ in MESH_CASES}


def _mesh_phase(torch, dev, inputs, devices=None, ranks=MESH_RANKS, small=False) -> dict:
    """Main path 10 on the card: each case on ``ranks`` ranks that share
    ``dev`` over gloo, then once over nccl at world size 1; launches
    summed over the ranks of the measured runs."""
    from dspfun_tpu_torch.parallel.mesh import RankPool

    t_phase = time.perf_counter()
    dev_name = str(dev) if devices is None else devices
    total: dict = {}
    readings = {}
    for n in ranks:
        t0 = time.perf_counter()
        with RankPool([dev_name] * n, "gloo", timeout_s=120.0) as pool:
            start_s = time.perf_counter() - t0
            meshes = _mesh_meshes(pool, n)
            for case, policy, what, at in MESH_CASES:
                if n not in at:
                    continue
                res = pool.run(_mesh_run, meshes[case], case, inputs, policy, small)
                _mesh_report(res, case, policy, what, meshes[case], n, "gloo", readings, total)
        print(f"phase 14: {n} ranks over gloo, pool start {start_s:.1f} s, "
              f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    # (b) every collective once over nccl at world size 1 (contiguity,
    # dtypes, the split sizes of all_to_all_single), small inputs
    t0 = time.perf_counter()
    nccl = {}
    if devices is None:
        with RankPool([str(dev)], "nccl", timeout_s=120.0) as pool:
            mesh = pool.mesh(space=1)
            for case, policy, what, _ in MESH_CASES:
                res = pool.run(_mesh_run, mesh, case, inputs, policy, True)
                nccl[case] = _mesh_report(res, case, policy, what, mesh, 1, "nccl", {}, {})
        print(f"phase 14 (b): every case over nccl at world size 1 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"phase 14 launches (measured runs, summed over ranks): {json.dumps(total)}; "
          f"{wall:.1f} s", flush=True)
    return {"launches": total, "readings": readings, "seconds": wall}


def _mesh_report(res, case, policy, what, mesh, n, backend, readings, total):
    """Print one case's readings and hold its errors to MESH_TOL."""
    errs = res[0]["errors"]
    bad = [k for k, tol in MESH_TOL.items() if k in errs and not errs[k] <= tol]
    if case == "spec":
        bad += [] if errs["dc"] <= 1e-6 else ["dc"]
    if case == "scan" and not errs["parity_equal"]:
        bad.append("parity")
    launches: dict = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
            total[k] = total.get(k, 0) + v
    wall = max(r["wall_s"] for r in res)
    coll = max(r["collective_s"] for r in res)
    peak = [None if r["peak_mib"] is None else round(r["peak_mib"], 1) for r in res]
    stages = {k: round(max(r["stages"].get(k, 0.0) for r in res), 4) for k in res[0]["stages"]}
    label = f"{case}{'' if policy is None else ' ' + policy}"
    print(f"mesh {label} on {n} rank(s) {mesh.shape} over {backend} ({what}): errors vs one "
          f"device {json.dumps({k: (round(v, 9) if isinstance(v, float) else v) for k, v in errs.items()})}; "
          f"launches {json.dumps(launches)}; collectives {json.dumps(res[0]['collectives'])}; "
          f"wall {wall:.4f} s, collectives {coll:.4f} s ({100 * coll / wall:.1f} % of the wall), "
          f"stages {json.dumps(stages)}; peak MiB per rank {peak}", flush=True)
    if bad:
        raise RuntimeError(f"mesh {label} on {n} ranks over {backend}: {bad} out of "
                           f"tolerance: {errs}")
    readings[f"{label} x{n}"] = {"wall_s": wall, "collective_s": coll, "stages": stages,
                                 "peak_mib": peak, "launches": launches}
    return readings.get(f"{label} x{n}")


def _mesh_cli_phase(torch, video, images, clip, png) -> None:
    """(c) The CLIs over nccl with one rank per card: with one card a
    mesh of two is refused (exit 1); with more, motion --mesh space=2 and
    spec -M 2 run and equal one device's output."""
    from dspfun_tpu_torch.tools import motion, spec

    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_cli_") as tmp:
        one_m, mesh_m = os.path.join(tmp, "one.y4m"), os.path.join(tmp, "mesh.y4m")
        one_s, mesh_s = os.path.join(tmp, "one.png"), os.path.join(tmp, "mesh.png")
        margs = MOTION_ARGS + [clip]
        if n < 2:
            for mod, args in ((motion, margs + ["--mesh", "2", mesh_m]),
                              (spec, ["-M", "2", png, mesh_s])):
                rc = mod.main(args)
                print(f"{mod.__name__.rsplit('.', 1)[-1]} --mesh 2 on one card: exit {rc}",
                      flush=True)
                if rc != 1 or os.path.exists(mesh_m) or os.path.exists(mesh_s):
                    raise RuntimeError("a mesh of two on one card was not refused")
            return
        for mod, one, mesh, args, margs_ in ((motion, one_m, mesh_m, margs, ["--mesh", "space=2"]),
                                             (spec, one_s, mesh_s, [png], ["-M", "2"])):
            t0 = time.perf_counter()
            if mod.main(args + [one]) != 0:
                raise RuntimeError(f"{mod.__name__} on one card failed")
            t1 = time.perf_counter()
            if mod.main(margs_ + args + [mesh]) != 0:
                raise RuntimeError(f"{mod.__name__} {margs_} over nccl failed")
            t2 = time.perf_counter()
            if mod is motion:
                same = open(one, "rb").read() == open(mesh, "rb").read()
            else:
                a, b = images.read_image(one).pixels, images.read_image(mesh).pixels
                same = float(np.max(np.abs(a - b))) <= 2.0 / 65535
            print(f"{mod.__name__.rsplit('.', 1)[-1]} {' '.join(margs_)} over nccl on 2 cards: "
                  f"{t2 - t1:.3f} s against {t1 - t0:.3f} s on one; output equal: {same}",
                  flush=True)
            if not same:
                raise RuntimeError(f"{mod.__name__} over nccl differs from one card")


# phase 15: the ffmpeg bridge, ffplay:, BMP and sixel ----------------------
BRIDGE_FRAMES = 8                 # phase 6's clip, its first 8 frames (one slab)
BRIDGE_BMP_HW = (H, W)            # (c): spec of a 3840x2160 RGB BMP at i8@1e-5
SIXEL_HW = (360, 640)             # (d): ispec to sixel: at 640x360
# (d): the sha256 of the JAX package's sixel (Pillow's median cut) of this
# phase's source image, the levels of _seeded_png(..., SIXEL_HW, 16,
# noise=0.02), computed with Pillow, which the card's machine lacks; pinned
# by tests/test_torch_sixel.py
SIXEL_DIGEST = "dd5e12e759eff2cfa290eb03d11488dc05fa09d1088cd766d646e93988511554"


def _shim_module():
    """``tests/torch_ffmpeg_shims.py`` of this checkout, loaded by its path
    (another installed package may be named ``tests``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_ffmpeg_shims.py")
    spec = importlib.util.spec_from_file_location("torch_ffmpeg_shims", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixtures_module():
    """``tests/torch_codec_fixtures.py`` of this checkout (its TIFF writer
    and fixture tables need no Pillow), loaded by its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_codec_fixtures.py")
    spec = importlib.util.spec_from_file_location("torch_codec_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shim_probe(path, pix_fmt, nframes, hw):
    with open(path, "w") as f:
        json.dump({"streams": [{"codec_type": "video", "pix_fmt": pix_fmt,
                                "nb_frames": str(nframes), "avg_frame_rate": "25/1",
                                "width": hw[1], "height": hw[0], "color_range": "tv"}],
                   "format": {}}, f)


def _y4m_payload(path):
    """The frame payloads of a y4m file, its FRAME lines and header dropped."""
    with open(path, "rb") as f:
        f.readline()
        return b"".join(f.read().split(b"FRAME\n"))


def _decode_sixel(data: bytes):
    """(index image [H, W], palette [N, 3] in whole percents) of a sixel
    stream as io/sixel.py writes it."""
    import re

    body = data[3:-2].decode()
    m = re.match(r'"1;1;(\d+);(\d+)', body)
    w, h = int(m.group(1)), int(m.group(2))
    pal, idx = {}, np.full((h, w), -1, np.int64)
    i, color, x, y0 = m.end(), 0, 0, 0
    while i < len(body):
        ch = body[i]
        if ch == "#":
            m = re.match(r"#(\d+)(;2;(\d+);(\d+);(\d+))?", body[i:])
            color = int(m.group(1))
            if m.group(2):
                pal[color] = tuple(int(m.group(k)) for k in (3, 4, 5))
            i += m.end()
            continue
        if ch in "$-":
            x, y0, i = 0, y0 + 6 * (ch == "-"), i + 1
            continue
        run = 1
        if ch == "!":
            m = re.match(r"!(\d+)", body[i:])
            run, i = int(m.group(1)), i + m.end()
            ch = body[i]
        bits = ord(ch) - 63
        for r in range(6):
            if bits >> r & 1 and y0 + r < h:
                idx[y0 + r, x:x + run] = color
        x, i = x + run, i + 1
    if (idx < 0).any():
        raise RuntimeError("sixel: a pixel was never painted")
    lut = np.zeros((max(pal) + 1, 3), np.int64)
    for k, v in pal.items():
        lut[k] = v
    return idx, lut


def _bridge_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, hw=(MH, MW),
                  frames=BRIDGE_FRAMES, bmp_hw=BRIDGE_BMP_HW, sixel_hw=SIXEL_HW,
                  device_args=()) -> dict:
    """Main path 11: motion through the ffmpeg bridge (shim binaries) both
    ways at 8 and 10 bits, an ``ffplay:`` sink, spec of a BMP and ispec
    back to BMP, ispec to sixel.  Returns the kernels' launches over the
    measured runs."""
    import hashlib

    from dspfun_tpu_torch.io import ffmpeg_bridge, images, video
    from dspfun_tpu_torch.io import sixel as _sixel
    from dspfun_tpu_torch.tools import ispec, motion, spec
    shims = _shim_module()
    FAKE_HEADER, install_shims = shims.FAKE_HEADER, shims.install_shims

    h, w = hw
    count = _Launches(torch, int8mm, block_filter)
    launches, counted = count.total, count.run

    def run_motion(src, dst):
        t0 = time.perf_counter()
        rc = motion.main(MOTION_ARGS + list(device_args) + [src, dst])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"motion {src} -> {dst} exited {rc}")
        return time.perf_counter() - t0, dict(motion.LAST_STAGE_TIMES)

    saved_env = {k: os.environ.get(k) for k in ("PATH", "SHIM_LOG", "SHIM_PROBE")}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bridge_") as tmp:
        bindir = install_shims(os.path.join(tmp, "bin"))
        log = os.path.join(tmp, "shim.log")
        probe = os.path.join(tmp, "probe.json")
        os.environ["PATH"] = f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"
        os.environ["SHIM_LOG"] = log
        os.environ["SHIM_PROBE"] = probe
        ffmpeg_bridge.have_ffmpeg.cache_clear()
        ffmpeg_bridge.have_ffprobe.cache_clear()
        try:
            # ---- (a) motion through the bridge, 8-bit (y4m transport) ----
            clip = os.path.join(tmp, "clip.y4m")
            planes = _write_clip(video, clip, frames, hw)
            mp4 = os.path.join(tmp, "in.mp4")
            with open(mp4, "wb") as f:
                f.write(FAKE_HEADER + open(clip, "rb").read())
            _shim_probe(probe, "yuv420p", frames, hw)
            t0 = time.perf_counter()
            meta = ffmpeg_bridge.probe(mp4)
            probe_s = time.perf_counter() - t0
            if meta["streams"][0]["nb_frames"] != str(frames):
                raise RuntimeError(f"shim probe: {meta}")
            ref = os.path.join(tmp, "ref.y4m")
            run_motion(clip, ref)                           # plans, warm
            out = os.path.join(tmp, "out.mp4")
            (wall, stages), got = counted(lambda: run_motion(mp4, out))
            nbytes = os.path.getsize(mp4)
            print(f"phase 15a bridge 8-bit {w}x{h} {frames} frames: launches {json.dumps(got)}; "
                  f"probe {probe_s:.4f} s, pump in (read) {stages.get('read', 0):.4f} s "
                  f"({nbytes / 1e6 / max(stages.get('read', 0), 1e-9):.1f} MB/s), compute "
                  f"{stages.get('compute', 0):.4f} s, pump out (write) "
                  f"{stages.get('write', 0):.4f} s "
                  f"({os.path.getsize(out) / 1e6 / max(stages.get('write', 0), 1e-9):.1f} MB/s)"
                  f", wall {wall:.3f} s", flush=True)
            if not (got.get("right3") and got.get("block_filter")):
                raise RuntimeError(f"phase 15a: kernels #2 and #3 did not launch: {got}")
            same = open(out, "rb").read() == open(ref, "rb").read()
            print(f"phase 15a mp4 -> mp4 through the bridge == y4m -> y4m: {same}", flush=True)
            if not same:
                raise RuntimeError("phase 15a: the bridge run differs from the y4m run")
            argv = [json.loads(ln) for ln in open(log)]
            dec = next(a for a in argv if "-map" in a and a[a.index("-i") + 1] == mp4)
            enc = next(a for a in argv if a[-1] == out)
            if not (dec[dec.index("-f") + 1] == "yuv4mpegpipe"
                    and enc[enc.index("-f") + 1] == "yuv4mpegpipe"
                    and "-c:v" not in enc):     # mp4: ffmpeg's default codec
                raise RuntimeError(f"phase 15a: unexpected ffmpeg argv {argv}")

            # ---- (a) 10-bit: rawvideo transport, RawReader/RawWriter ----
            pf10 = video.PIXEL_FORMATS["yuv420p10le"]
            clip10 = os.path.join(tmp, "clip10.y4m")
            rng = np.random.default_rng(10)
            raw10 = bytearray(FAKE_HEADER)
            with video.open_output(clip10, w, h, Fraction(25, 1),
                                   video.ColorProps(pix_fmt="yuv420p10le")) as wr:
                for t in range(frames):
                    fr = [(p[t].astype(np.uint16) * 4
                           + rng.integers(0, 4, p[t].shape)).astype("<u2") for p in planes]
                    wr.write_frame(fr, raw=True)
                    raw10 += b"".join(x.tobytes() for x in fr)
            mp4_10 = os.path.join(tmp, "in10.mp4")
            with open(mp4_10, "wb") as f:
                f.write(raw10)
            _shim_probe(probe, "yuv420p10le", frames, hw)
            ref10 = os.path.join(tmp, "ref10.y4m")
            run_motion(clip10, ref10)
            out10 = os.path.join(tmp, "out10.mp4")
            (wall, stages), got = counted(lambda: run_motion(mp4_10, out10))
            argv = [json.loads(ln) for ln in open(log)]
            # the two shims log as they start, in either order
            dec = next(a for a in argv if "-map" in a and a[a.index("-i") + 1] == mp4_10)
            enc = next(a for a in argv if a[-1] == out10)
            if not (dec[dec.index("-pix_fmt") + 1] == "yuv420p10le"
                    and dec[dec.index("-f", dec.index("-map")) + 1] == "rawvideo"
                    and enc[enc.index("-pixel_format") + 1] == "yuv420p10le"):
                raise RuntimeError(f"phase 15a 10-bit: not the rawvideo transport: {argv[-2:]}")
            same = open(out10, "rb").read() == _y4m_payload(ref10)
            print(f"phase 15a bridge 10-bit (rawvideo both ways): launches {json.dumps(got)}; "
                  f"read {stages.get('read', 0):.4f} s "
                  f"({(len(raw10) - 8) / 1e6 / max(stages.get('read', 0), 1e-9):.1f} MB/s), "
                  f"compute {stages.get('compute', 0):.4f} s, write {stages.get('write', 0):.4f}"
                  f" s, wall {wall:.3f} s; payload == y4m run's: {same}", flush=True)
            if not (same and got.get("right3") and got.get("block_filter")):
                raise RuntimeError("phase 15a 10-bit failed")

            # ---- (b) an ffplay: sink ----
            t0 = time.perf_counter()
            props = video.parse_color_props("pixel_format=yuv420p:color_range=jpeg:"
                                            "color_trc=linear")
            with video.open_output("ffplay:", w, h, Fraction(25), props) as wr:
                wr.write_frame([p[0] for p in planes], raw=True)
            play = [json.loads(ln) for ln in open(log)][-1]
            want = {"-color_range": "pc", "-color_trc": "linear", "-pixel_format": "yuv420p",
                    "-video_size": f"{w}x{h}"}
            have = {k: play[play.index(k) + 1] for k in want}
            print(f"phase 15b ffplay: argv {json.dumps(have)} in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            if have != want:
                raise RuntimeError(f"phase 15b: ffplay argv {play}")
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            ffmpeg_bridge.have_ffmpeg.cache_clear()
            ffmpeg_bridge.have_ffprobe.cache_clear()

        # ---- (c) spec and ispec of a BMP at i8@1e-5 ----
        bh, bw = bmp_hw
        src_png = os.path.join(tmp, "in.png")
        src_bmp = os.path.join(tmp, "in.bmp")
        pix = _seeded_png(images, src_png, bmp_hw, 15, noise=0.02)
        images.write_image(src_bmp, pix)
        t0 = time.perf_counter()
        from_bmp = images.read_image(src_bmp)
        bmp_s = time.perf_counter() - t0
        if not np.array_equal(from_bmp.pixels, images.read_image(src_png).pixels):
            raise RuntimeError("phase 15c: the BMP does not hold the PNG's pixels")
        print(f"phase 15c BMP {bw}x{bh}: decode {bmp_s:.4f} s, {os.path.getsize(src_bmp)} bytes",
              flush=True)
        spec_i8 = {"left3": 1, "right3": 1} if min(bmp_hw) >= 256 else {}
        with _policy("i8@1e-5"):
            s_png, s_bmp = os.path.join(tmp, "s_png.png"), os.path.join(tmp, "s_bmp.png")
            b_bmp = os.path.join(tmp, "b_bmp.bmp")
            for name, mod, args in (("spec png", spec, [src_png, s_png]),
                                    ("spec bmp", spec, [src_bmp, s_bmp]),
                                    ("ispec bmp", ispec, [s_bmp, b_bmp])):
                measured = name.endswith("bmp")
                fn = lambda mod=mod, args=args: _run_tool(  # noqa: E731
                    torch, mod, list(device_args) + ["-t", "flat", "-G", "1000"] + args, int8mm)
                (wall, stages, got), _ = counted(fn) if measured else (fn(), None)
                print(f"phase 15c {name} {bw}x{bh}: {wall:.3f} s; stages {_stages(stages)}; "
                      f"launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 15c {name} launched {got}, expected {spec_i8}")
        same_spec = open(s_png, "rb").read() == open(s_bmp, "rb").read()
        back = images.read_image(b_bmp).pixels
        same_back = back.shape == pix.shape and bool(np.isfinite(back).all())
        print(f"phase 15c spectrum from the BMP == from the PNG: {same_spec}; ispec's BMP reads "
              f"back at {back.shape}: {same_back}", flush=True)
        if not (same_spec and same_back):
            raise RuntimeError("phase 15c: the BMP route differs from the PNG route")

        # ---- (d) ispec to sixel: ----
        sh, sw = sixel_hw
        src6 = os.path.join(tmp, "six.png")
        _seeded_png(images, src6, sixel_hw, 16, noise=0.02)
        spec6 = os.path.join(tmp, "six_spec.png")
        _run_tool(torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", src6, spec6],
                  int8mm)
        six, ppm = os.path.join(tmp, "out.six"), os.path.join(tmp, "ref.ppm")
        for target in (f"sixel:{six}", f"ppm:{ppm}"):
            wall, stages, _ = _run_tool(torch, ispec, list(device_args)
                                        + ["-t", "flat", "-G", "1000", spec6, target], int8mm)
            if target.startswith("sixel"):
                sixel_s = stages.get("write", 0.0)
        data = open(six, "rb").read()
        ppm_data = open(ppm, "rb").read()
        ref8 = np.frombuffer(ppm_data[ppm_data.index(b"255\n") + 4:], np.uint8).reshape(sh, sw, 3)
        idx, _ = _decode_sixel(data)
        src8 = _rgb8(_seeded_pixels(sixel_hw, 16, noise=0.02))
        t0 = time.perf_counter()
        digest = hashlib.sha256(_sixel.encode_sixel(src8)).hexdigest()
        enc_s = time.perf_counter() - t0
        ok = idx.shape == (sh, sw) and _sixel.encode_sixel(ref8) == data and (
            digest == SIXEL_DIGEST or tuple(sixel_hw) != SIXEL_HW)
        print(f"phase 15d sixel {sw}x{sh}: {len(data)} bytes; ispec's sixel == encode_sixel of "
              f"its levels, and encode_sixel of the source levels == the JAX encoder's digest: "
              f"{'PASS' if ok else 'FAIL'}; ispec write {sixel_s:.4f} s, encode of the source "
              f"{enc_s:.4f} s", flush=True)
        if not ok:
            raise RuntimeError(f"phase 15d: sixel output is not the JAX encoder's ({digest})")
    # kernels #1-#3 against their plain versions at every shape the runs gave them
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"bridge {layout}{nd} {m}x{k}")
        _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    print(f"phase 15 {time.perf_counter() - t_phase:.1f} s; launches {json.dumps(launches)}; "
          f"int8 shapes {sorted(count.shapes)}; block filter shapes {sorted(count.bf_shapes)}",
          flush=True)
    return launches


class _Launches:
    """The int8 and block filter kernels' launches over runs of a phase:
    every count set to 0 just before a run and read just after it, the
    int8 kernels' shapes (``shapes``) and the block filter's (NB, dims)
    (``bf_shapes``) recorded; ``total`` sums the runs counted into the
    main path."""

    def __init__(self, torch, int8mm, block_filter):
        self.torch, self.int8mm, self.block_filter = torch, int8mm, block_filter
        self.total: dict = {}
        self.shapes: set = set()
        self.bf_shapes: set = set()

    def bf_checks(self) -> tuple:
        """``_check_block_filter``'s shapes for the block filter's calls on
        this path (motion's linear chroma filter)."""
        return tuple((f"chroma {'x'.join(map(str, dims))} NB={nb}", nb, dims)
                     for nb, dims in sorted(self.bf_shapes))

    def run(self, fn, into=True):
        int8mm, i8_groups = self.int8mm, self.int8mm._i8_groups
        block_filter, fused = self.block_filter, self.block_filter.fused_block_filter

        def spy(a, x, layout):      # the int8 kernels' shapes on this path
            nd, m, _ = a.shape
            b, r, k = (x.shape[1], x.shape[3], x.shape[2]) if layout == "left" \
                else (x.shape[1], x.shape[2], x.shape[3])
            self.shapes.add((nd, layout, m, k, b, r))
            return i8_groups(a, x, layout)

        def bf_spy(blocks, dims, *args, **kwargs):
            self.bf_shapes.add((int(blocks.shape[0]), tuple(int(d) for d in dims)))
            return fused(blocks, dims, *args, **kwargs)

        int8mm.LAUNCHES.clear()
        block_filter.LAUNCHES.clear()
        int8mm._i8_groups = spy
        block_filter.fused_block_filter = bf_spy
        try:
            out = fn()
        finally:
            int8mm._i8_groups = i8_groups
            block_filter.fused_block_filter = fused
        self.torch.cuda.synchronize()
        got = {n: c for n, c in {**int8mm.LAUNCHES, **self.block_filter.LAUNCHES}.items() if c}
        if into:
            for n, c in got.items():
                self.total[n] = self.total.get(n, 0) + c
        return out, got


# phase 16: JPEG in and out (io/jpeg.py, native/jpeg.cpp) ----------------------
# (a): (hw, seed) of _seeded_pixels, the 4K image and an odd-sized one, and
# the sha256 of Pillow's default JPEG of each and of Pillow's decode of it
# (tests/test_torch_jpeg.py pins them to Pillow)
JPEG_IMAGES = (((H, W), 17), ((333, 517), 18))
JPEG_DIGESTS = {
    (H, W): ("2922d2f07e91ec1e77407005f830fb1857476705f3025593be4dc4d2871b01f2",
             "e521fd3273e5075518eed789cee3c85e695b479b7312f1c4e22a281f3c5df3a9"),
    (333, 517): ("f003e5ba82df34a0b6c27b9b941b28a4da4a957c5bd303800416c08e4146b589",
                 "b90c8df1a83ae46a02a25fa98d70e78b1081469b6e6dda7acee804ef104ecd07"),
}
JPEG_FRAMES = 8                   # (c): motion's lowpass on 8 1080p frames


def _jpeg_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, jpeg_images=JPEG_IMAGES,
                motion_hw=(MH, MW), frames=JPEG_FRAMES, device_args=()) -> dict:
    """Main path 12: JPEG in and out through the port's own codec.  (a)
    The seeded images encoded and decoded: their digests Pillow's; (b)
    spec of the first image's JPEG at ``i8@1e-5`` against a PNG of its
    decoded pixels, and ispec back to JPEG; (c) motion's lowpass on a
    1080p JPEG sequence to y4m against a PPM sequence of its decoded
    frames.  Returns the kernels' launches over the JPEG runs."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, jpeg
    from dspfun_tpu_torch.tools import ispec, motion, spec

    count = _Launches(torch, int8mm, block_filter)
    launches, shapes, counted = count.total, count.shapes, count.run
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg._load()
    print(f"phase 16 libjpeg build and load: {time.perf_counter() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as tmp:
        # ---- (a) encode and decode, held to Pillow's digests ----
        first = None
        for hw, seed in jpeg_images:
            h, w = hw
            pix = _seeded_pixels(hw, seed)
            rgb8 = np.clip(np.rint(np.clip(pix, 0.0, 1.0) * 255), 0, 255).astype(np.uint8)
            t0 = time.perf_counter()
            data = jpeg.encode_jpeg(rgb8)
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dec, _ = jpeg.decode_jpeg(data)
            dec_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"in_{w}x{h}.jpg")
            images.write_image(path, pix)
            got = (hashlib.sha256(data).hexdigest(), hashlib.sha256(dec.tobytes()).hexdigest())
            ok = got == JPEG_DIGESTS[tuple(hw)] and open(path, "rb").read() == data
            mb = h * w * 3 / 1e6
            print(f"phase 16a JPEG {w}x{h}: {len(data)} bytes; encode {enc_s:.4f} s "
                  f"({mb / enc_s:.1f} MB/s of RGB), decode {dec_s:.4f} s ({mb / dec_s:.1f} MB/s); "
                  f"file and pixels == Pillow's digests: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 16a: the {w}x{h} JPEG is not Pillow's: {got}")
            first = first or (path, hw)

        # ---- (b) spec and ispec of the JPEG against a PNG of its pixels ----
        src_jpg, (bh, bw) = first
        src_png = os.path.join(tmp, "in.png")
        images.write_image(src_png, images.read_image(src_jpg).pixels)
        spec_i8 = {"left3": 1, "right3": 1} if min(bh, bw) >= 256 else {}
        out = {k: os.path.join(tmp, k) for k in ("s_png.png", "s_jpg.png", "b_jpg.jpg")}
        with _policy("i8@1e-5"):
            for name, mod, args in (("spec png", spec, [src_png, out["s_png.png"]]),
                                    ("spec jpg", spec, [src_jpg, out["s_jpg.png"]]),
                                    ("ispec jpg", ispec, [out["s_jpg.png"], out["b_jpg.jpg"]])):
                fn = lambda mod=mod, args=args: _run_tool(  # noqa: E731
                    torch, mod, list(device_args) + ["-t", "flat", "-G", "1000"] + args, int8mm)
                (wall, stages, got), _ = counted(fn, into=name.endswith("jpg"))
                print(f"phase 16b {name} {bw}x{bh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 16b {name} launched {got}, expected {spec_i8}")
        back = images.read_image(out["b_jpg.jpg"]).pixels
        ok = same(out["s_png.png"], out["s_jpg.png"]) and back.shape[:2] == (bh, bw)
        print(f"phase 16b at i8@1e-5: spectrum from the JPEG == from the PNG, ispec's JPEG "
              f"reads back at {back.shape}: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 16b: the JPEG route differs from the PNG route")

        # ---- (c) motion's lowpass on a JPEG sequence against a PPM one ----
        # the inputs straight from the codecs (the bytes write_image would
        # write): a seeded strip, a window 4 columns further on each frame
        mh, mw = motion_hw
        base = _seeded_pixels((mh, mw + 4 * frames), 19)
        base = np.clip(np.rint(np.clip(base, 0.0, 1.0) * 255), 0, 255).astype(np.uint8)
        enc_s = copy_s = 0.0
        for k in range(frames):
            t0 = time.perf_counter()
            data = jpeg.encode_jpeg(base[:, 4 * k:4 * k + mw])
            enc_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.jpg"), "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            ppm = imgcodecs.encode_pnm(jpeg.decode_jpeg(data)[0])
            copy_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(ppm)
        print(f"phase 16c {frames} frames {mw}x{mh}: JPEG encode {enc_s:.3f} s, "
              f"decode + PPM copy {copy_s:.3f} s", flush=True)
        runs = {}
        for src in ("ppm", "jpg"):
            target = os.path.join(tmp, f"o_{src}.y4m")
            t0 = time.perf_counter()

            def run(src=src, target=target):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{src}"), target])
                if rc != 0:
                    raise RuntimeError(f"phase 16c motion {src} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, got = counted(run, into=src == "jpg")
            runs[src] = got
            print(f"phase 16c motion {src} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches {json.dumps(got)}",
                  flush=True)
        ok = same(os.path.join(tmp, "o_jpg.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 16c JPEG sequence == PPM sequence to y4m: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 16c: the JPEG sequence's y4m differs from the PPM's")
        got = runs["jpg"]
        if got != runs["ppm"] or not (got.get("right3") or got.get("block_filter")):
            raise RuntimeError(f"phase 16c: launches {got} (PPM route {runs['ppm']}); kernels "
                               "#2 and #3 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(shapes):
            check_i8mm(nd, layout, m, k, b, r, f"jpeg {layout}{nd} {m}x{k}")
        if launches.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 16 {wall:.1f} s; launches {json.dumps(launches)}", flush=True)
    return {"launches": launches, "shapes": sorted(shapes)}


# phase 17: progressive JPEG and compressed TIFF (io/jpeg.py, io/imgcodecs.py) --
# (a): the fixtures of tests/goldens/ (tests/torch_codec_fixtures.py makes them
# with Pillow): the sha256 of each file and of Pillow's decode of it
# (np.asarray(Image.open(...))), pinned by tests/test_torch_jpeg.py
CODEC_FIXTURES = {
    "codec_prog_4k.jpg": ("3d382cfbe57ff35d20a4f79aa21d76dc3e0463cfaf653c87e7bba487569a8214",
                          "d7027c43d242312e4986ffad0ce6a4be67e11946f7806210e8a5e848971ebb50"),
    "codec_prog_gray.jpg": ("1c2957dc80c2c84fdb2c4bf187e6cca57c5d708ea44047882c6a31707eaea3c4",
                            "7078d84cf03f63d133cca943c08ec23244ffcae67543bd0b317f899e2443b3e6"),
    "codec_prog_444_rst.jpg": (
        "c7c0b5c60d1086d180b11a8302fd28941249f86d655c1bc3e3b5db41ddab6e47",
        "91c9650fbd43ff9bd50ab7a01cac085ffe53c8cdc3b6cfd9a81dbc85d3c75b5f"),
    "codec_lzw_p1.tif": ("113fcc3eb59c4a69a2ad12bdc309d3f11e50583f27af88755de897cd4bdd9786",
                         "26e602e2488eedb07c91e37aefd57f2fecf3364c5573099b5a25e535e9224de5"),
    "codec_lzw_p2.tif": ("7c1ff693ae01d2facc7fb6b2392548d153507aac5a19c849099947ebb75ae289",
                         "26e602e2488eedb07c91e37aefd57f2fecf3364c5573099b5a25e535e9224de5"),
    "codec_packbits.tif": ("f16f76dd249bacabfd5359791345a36360fdd8aa84365c86f4a0ef8aa4b30c36",
                           "26e602e2488eedb07c91e37aefd57f2fecf3364c5573099b5a25e535e9224de5"),
    "codec_rgba_assoc.tif": ("9c267b63a84d4a47518dd521a038cae3f60c5d03486c0bd27885362de4b4c12a",
                             "7ef3fc5b46e2d950a6b59b7b9a1d5e6f3baeb9ab27c0e71e02024015ae61ff59"),
}
CODEC_4K = ((H, W), 17, 0.02)     # (hw, seed, noise) of codec_prog_4k.jpg's levels
CODEC_FRAMES = 8                  # (c): motion's lowpass on 8 1080p deflate TIFF frames


def _rgb8(pix) -> np.ndarray:
    """The 8-bit levels ``write_image`` makes of float pixels."""
    return np.clip(np.rint(np.clip(pix, 0.0, 1.0) * 255), 0, 255).astype(np.uint8)


def _deflate_tiff(fx, rgb, predictor) -> bytes:
    """A little-endian deflate (8) TIFF of uint8 RGB [h, w, 3] in strips of
    64 rows, horizontal predictor 1 or 2, written with the standard
    library's zlib by ``tests/torch_codec_fixtures.py:make_tiff``, as GIMP
    or a scanner writes one."""
    return fx.make_tiff(rgb, "RGB", compression=8, predictor=predictor, rows_per_strip=64)


def _codecs_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, motion_hw=(MH, MW),
                  frames=CODEC_FRAMES, device_args=(), spec_crop=None) -> dict:
    """Main path 13: progressive JPEG and compressed TIFF through the
    port's own codecs.  (a) The fixtures of tests/goldens/ decoded, each
    equal to Pillow's digest; the 4K progressive decode equal to the
    port's decode of its baseline encode of the same levels; 4K deflate
    TIFFs at predictor 1 and 2, written with zlib (``make_tiff``),
    decoded to their levels.  (b) spec of the 4K progressive JPEG and of
    the 4K deflate TIFF at ``i8@1e-5`` against a PNG of the decoded
    pixels, and ispec of each at ``i8@1e-5`` back to its format
    (``spec_crop``: the 517x333 fixture and a TIFF of that size, for a
    rehearsal on the CPU).  (c) motion's lowpass on a 1080p deflate TIFF
    sequence against a PPM sequence of the same levels.  Returns the
    kernels' launches over the runs of the progressive JPEG and the
    TIFFs."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, jpeg
    from dspfun_tpu_torch.tools import ispec, motion, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg._load()
    imgcodecs._tiff_lib()
    print(f"phase 17 libjpeg and libtiff build and load: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as tmp:
        # ---- (a) decodes: Pillow's digests, the baseline route, zlib's TIFFs ----
        decoders = {".jpg": jpeg.decode_jpeg, ".tif": imgcodecs.decode_tiff}
        for name, want in CODEC_FIXTURES.items():
            with open(os.path.join(gold, name), "rb") as f:
                data = f.read()
            if images._decoder(data) is not decoders[name[-4:]]:
                raise RuntimeError(f"phase 17a: {name} does not take the port's codec")
            t0 = time.perf_counter()
            arr, _ = decoders[name[-4:]](data)
            dec_s = time.perf_counter() - t0
            got = (sha(data), sha(np.ascontiguousarray(arr).tobytes()))
            h, w = arr.shape[:2]
            print(f"phase 17a {name} {w}x{h}: {len(data)} bytes; decode {dec_s:.4f} s "
                  f"({h * w * 3 / 1e6 / dec_s:.1f} MB/s of RGB); file and pixels == Pillow's "
                  f"digests: {got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 17a: {name} is not Pillow's: {got}")
            if name == "codec_prog_4k.jpg":
                prog, prog_s = arr, dec_s
            if name.startswith("codec_lzw"):      # a small file: the rate includes the calls
                t0 = time.perf_counter()
                for _ in range(20):
                    imgcodecs.decode_tiff(data)
                rep_s = (time.perf_counter() - t0) / 20
                print(f"phase 17a {name} decoded 20 times: {rep_s:.5f} s each "
                      f"({arr.nbytes / 1e6 / rep_s:.1f} MB/s of output)", flush=True)
        (bh, bw), seed, noise = CODEC_4K
        rgb8 = _rgb8(_seeded_pixels((bh, bw), seed, noise))
        base = jpeg.encode_jpeg(rgb8)
        t0 = time.perf_counter()
        ok = np.array_equal(jpeg.decode_jpeg(base)[0], prog)
        print(f"phase 17a 4K progressive decode == the port's decode of its own baseline "
              f"encode of the same levels: {ok} (baseline decode {time.perf_counter() - t0:.4f} s, "
              f"{len(base)} bytes)", flush=True)
        if not ok:
            raise RuntimeError("phase 17a: the progressive decode differs from the baseline one")
        tifs = {}
        for predictor in (1, 2):
            t0 = time.perf_counter()
            data = _deflate_tiff(fx, rgb8, predictor)
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            arr, _ = imgcodecs.decode_tiff(data)
            dec_s = time.perf_counter() - t0
            ok = np.array_equal(arr, rgb8)
            tifs[predictor] = os.path.join(tmp, f"deflate_p{predictor}.tif")
            with open(tifs[predictor], "wb") as f:
                f.write(data)
            mb = bh * bw * 3 / 1e6
            print(f"phase 17a deflate TIFF {bw}x{bh} predictor {predictor}: {len(data)} bytes, "
                  f"written with zlib in {enc_s:.3f} s; decode {dec_s:.4f} s ({mb / dec_s:.1f} "
                  f"MB/s of RGB); == its levels: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 17a: the predictor {predictor} deflate TIFF decodes "
                                   "to other levels")

        # ---- (b) spec and ispec of each against a PNG of its decoded pixels ----
        if spec_crop is None:
            sources = {"jpg": os.path.join(gold, "codec_prog_4k.jpg"), "tif": tifs[2]}
        else:
            ch, cw = spec_crop
            sources = {"jpg": os.path.join(gold, "codec_prog_444_rst.jpg"),
                       "tif": os.path.join(tmp, "crop.tif")}
            with open(sources["tif"], "wb") as f:
                f.write(_deflate_tiff(fx, np.ascontiguousarray(rgb8[:ch, :cw]), 2))
        spectra = {}
        for ext, src in sources.items():
            ref = os.path.join(tmp, f"ref_{ext}.png")
            pix = images.read_image(src).pixels
            images.write_image(ref, pix)
            sh, sw = pix.shape[:2]
            spec_i8 = {"left3": 1, "right3": 1} if min(sh, sw) >= 256 else {}
            policy = tag = "i8@1e-5"
            out = {k: os.path.join(tmp, f"{k}_{ext}_{tag}.png") for k in ("ref", "src")}
            with _policy(policy):
                for name, inp in (("ref", ref), ("src", src)):
                    fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                        torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o],
                        int8mm)
                    (wall, stages, got), _ = count.run(fn, into=name == "src")
                    what = f"spec {os.path.basename(inp)}"
                    print(f"phase 17b {what} {sw}x{sh} at {tag}: {wall:.3f} s; stages "
                          f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                    if got != spec_i8:
                        raise RuntimeError(f"phase 17b {what} at {tag} launched {got}, "
                                           f"expected {spec_i8}")
            ok = same(out["ref"], out["src"])
            with open(out["src"], "rb") as f:
                spectra[ext] = sha(f.read())
            print(f"phase 17b {ext} at {tag}: spectrum == the PNG route's: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 17b at {tag}: the {ext} route differs from PNG's")
            if ext == "jpg":        # phase 16b runs ispec to a 4K JPEG
                continue
            back = os.path.join(tmp, "back.tiff")
            with _policy("i8@1e-5"):
                fn = lambda: _run_tool(torch, ispec, list(device_args)  # noqa: E731
                                       + ["-t", "flat", "-G", "1000", out["src"], back], int8mm)
                (wall, stages, got), _ = count.run(fn)
            res = images.read_image(back).pixels
            ok = got == spec_i8 and res.shape == pix.shape and bool(np.isfinite(res).all())
            print(f"phase 17b ispec to .{ext} at i8@1e-5: {wall:.3f} s; stages {_stages(stages)}; "
                  f"launches {json.dumps(got)}; max abs diff to the input "
                  f"{float(np.abs(res - pix).max()):.4f}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 17b ispec to .{ext} launched {got} or wrote "
                                   f"{res.shape}")

        # ---- (c) motion's lowpass on a deflate TIFF sequence against a PPM one ----
        mh, mw = motion_hw
        strip = _rgb8(_seeded_pixels((mh, mw + 4 * frames), 20))
        enc_s = dec_s = 0.0
        for k in range(frames):
            frame = np.ascontiguousarray(strip[:, 4 * k:4 * k + mw])
            t0 = time.perf_counter()
            data = _deflate_tiff(fx, frame, 1 + k % 2)
            enc_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            if not np.array_equal(imgcodecs.decode_tiff(data)[0], frame):
                raise RuntimeError(f"phase 17c: TIFF frame {k} decodes to other levels")
            dec_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"frame{k:04d}.tif"), "wb") as f:
                f.write(data)
            with open(os.path.join(tmp, f"frame{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(frame))
        print(f"phase 17c {frames} frames {mw}x{mh}: deflate TIFF write {enc_s:.3f} s, decode "
              f"{dec_s:.3f} s ({frames * mh * mw * 3 / 1e6 / dec_s:.1f} MB/s of RGB)", flush=True)
        runs = {}
        for src in ("ppm", "tif"):
            t0 = time.perf_counter()

            def run(src=src):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"frame%04d.{src}"),
                                    os.path.join(tmp, f"o_{src}.y4m")])
                if rc != 0:
                    raise RuntimeError(f"phase 17c motion {src} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, runs[src] = count.run(run, into=src == "tif")
            print(f"phase 17c motion {src} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches "
                  f"{json.dumps(runs[src])}", flush=True)
        ok = same(os.path.join(tmp, "o_tif.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 17c TIFF sequence == PPM sequence: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 17c: the TIFF sequence's output differs from the PPM's")
        if runs["tif"] != runs["ppm"] or not runs["tif"].get("right3"):
            raise RuntimeError(f"phase 17c: launches {runs['tif']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"codecs {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 17 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    # for phase 27: codec_prog_4k.jpg's decode seconds and (unless cropped) the
    # sha256 of its spectrum at i8@1e-5
    return {"launches": count.total, "shapes": sorted(count.shapes), "prog_4k_decode_s": prog_s,
            "prog_4k_spectrum": None if spec_crop else spectra["jpg"]}


# phase 18: GIF through the port's own codec (io/gif.py, io/quant.py) -----------
# (a): the GIF fixtures of tests/goldens/ (tests/torch_codec_fixtures.py makes
# them): the sha256 of each file and of Pillow's convert("RGBA") of it; and
# the 4K levels of CODEC_4K: the sha256 of Pillow's GIF of them and of its
# convert("RGBA"); both pinned by tests/test_torch_gif.py
GIF_FIXTURES = {
    "gif_rgb_interlaced.gif": (
        "c94ee94936b88691c684ad764fbba87363d9d6b69f0c85567d99728f133031bc",
        "098eb09b5d9129c5e93fcb0313581b29111902223ec837bc5195f934c9d919ee"),
    "gif_rgba_trns.gif": ("de75b1427e4dcb53cbcbc839646d9220e95a6d415bf816ea80d600dc731666c2",
                          "4fb4db23c1ecd8cc2e259b68ae8425589c329a76dbf5881e1924a8775c821ab4"),
    "gif_gray.gif": ("10d6252d43d01d00034b958a3f28614e42e2842a5a0af66471b77a591468879c",
                     "a315f84e34f86282b6439d92455ff3c37c102671fcf2d828851c31bc9e68e56e"),
    "gif_local_offset.gif": ("1c8de88fc51a52337b9cc5b3abf61b9910b884212217048f3dd8fd8358c5cfcc",
                             "2cbfe190be6e281cec2e646d4c307c2b2125e33b0408aef18e3f74c90184b0f0"),
    "gif_code2.gif": ("49554b26892bc907735e3f21353fef2a56877c533174c1fba4173bb323dc18f0",
                      "50df2c0a47b71fae8729bc6482be5d3651bf4b55bf0f4dd2e32dbeb7ff24199c"),
    "gif_deferred_clear.gif": (
        "80e0821cf5c291af6c61e30821744fb9a50ef7d5735f402824a2d8a8cd71dc94",
        "ae728a32a113df5bbe431a4b707b5e00e1e641bcb8bf7400a4379faa1660ce2f"),
}
GIF_DIGESTS = {
    (H, W): ("1077f7b8a60f7bb79c884db72ef75b08f1607fbe9c309c33cb8e2b2a084ba190",
             "d033e75ed0530d07646535786bdb10b0ad9ac4227f750e4fcb5f53d16eda14df"),
}
GIF_FRAMES = 8                    # (c): motion's lowpass on 8 1080p GIF frames


def _rgba8(samples) -> np.ndarray:
    """A decoded GIF's samples as RGBA (an opaque alpha where it has none)."""
    if samples.shape[2] == 4:
        return np.ascontiguousarray(samples)
    return np.dstack([samples, np.full(samples.shape[:2], 255, np.uint8)])


def _gif_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, big=CODEC_4K,
               motion_hw=(MH, MW), frames=GIF_FRAMES, device_args=()) -> dict:
    """Main path 14: GIF through the port's own codec.  (a) The fixtures of
    tests/goldens/ decoded, each equal to Pillow's digests; the 4K levels
    of ``big`` encoded (quantiser and LZW timed apart) to Pillow's bytes
    and decoded.  (b) spec of that GIF at ``i8@1e-5`` against a PNG of
    its decoded pixels, and ispec at ``i8@1e-5`` to ``.gif`` against
    ``encode_gif`` of the levels ispec writes to PPM.  (c) motion's
    lowpass on a 1080p GIF sequence to y4m against a PPM sequence of its
    decoded frames.  Returns the kernels' launches over the GIF runs."""
    import hashlib

    from dspfun_tpu_torch.io import gif, images, imgcodecs, quant
    from dspfun_tpu_torch.tools import ispec, motion, spec

    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    gif._load()
    quant._load()
    print(f"phase 18 libgif and libquant build and load: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gif_") as tmp:
        # ---- (a) the fixtures and the 4K levels, held to Pillow's digests ----
        for name, want in GIF_FIXTURES.items():
            with open(os.path.join(gold, name), "rb") as f:
                data = f.read()
            if images._decoder(data) is not gif.decode_gif:
                raise RuntimeError(f"phase 18a: {name} does not take the port's codec")
            t0 = time.perf_counter()
            arr, _ = gif.decode_gif(data)
            dec_s = time.perf_counter() - t0
            got = (sha(data), sha(_rgba8(arr).tobytes()))
            print(f"phase 18a {name} {arr.shape[1]}x{arr.shape[0]}: {len(data)} bytes; decode "
                  f"{dec_s:.4f} s; file and pixels == Pillow's digests: {got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 18a: {name} is not Pillow's: {got}")
        (bh, bw), seed, noise = big
        rgb8 = _rgb8(_seeded_pixels((bh, bw), seed, noise))
        t0 = time.perf_counter()
        idx, pal, _ = quant.quantize(rgb8)
        quant_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = gif.encode_gif(rgb8)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        arr, _ = gif.decode_gif(data)
        dec_s = time.perf_counter() - t0
        src_gif = os.path.join(tmp, "in.gif")
        images.write_image(src_gif, rgb8 / 255.0)
        got = (sha(data), sha(_rgba8(arr).tobytes()))
        want = GIF_DIGESTS.get((bh, bw))
        ok = (want is None or got == want) and open(src_gif, "rb").read() == data \
            and np.array_equal(arr, pal[idx])
        mb = bh * bw * 3 / 1e6
        print(f"phase 18a GIF {bw}x{bh}: {len(data)} bytes, {len(pal)} colours; quantise "
              f"{quant_s:.4f} s, LZW and container {enc_s - quant_s:.4f} s (encode {enc_s:.4f} s, "
              f"{mb / enc_s:.1f} MB/s of RGB), decode {dec_s:.4f} s ({mb / dec_s:.1f} MB/s); file "
              f"and pixels == Pillow's digests: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"phase 18a: the {bw}x{bh} GIF is not Pillow's: {got}")

        # ---- (b) spec and ispec of the GIF against a PNG of its pixels ----
        src_png = os.path.join(tmp, "in.png")
        images.write_image(src_png, images.read_image(src_gif).pixels)
        spec_i8 = {"left3": 1, "right3": 1} if min(bh, bw) >= 256 else {}
        policy = tag = "i8@1e-5"
        out = {k: os.path.join(tmp, f"{k}_{tag}.png") for k in ("png", "gif")}
        with _policy(policy):
            for name, src in (("png", src_png), ("gif", src_gif)):
                fn = lambda src=src, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", src, o],
                    int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "gif")
                print(f"phase 18b spec {name} {bw}x{bh} at {tag}: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 18b spec {name} at {tag} launched {got}, "
                                       f"expected {spec_i8}")
        ok = same(out["png"], out["gif"])
        print(f"phase 18b at {tag}: spectrum from the GIF == from the PNG: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"phase 18b at {tag}: the GIF route differs from the PNG route")
        backs = {ext: os.path.join(tmp, f"back.{ext}") for ext in ("gif", "ppm")}
        with _policy("i8@1e-5"):
            for ext, back in backs.items():
                fn = lambda back=back: _run_tool(  # noqa: E731
                    torch, ispec, list(device_args) + ["-t", "flat", "-G", "1000", out["gif"],
                                                       back], int8mm)
                (wall, stages, got), _ = count.run(fn, into=ext == "gif")
                print(f"phase 18b ispec to .{ext} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)} (write encodes); launches {json.dumps(got)}",
                      flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 18b ispec to .{ext} launched {got}")
        levels = _rgb8(images.read_image(backs["ppm"]).pixels)
        t0 = time.perf_counter()
        again = gif.encode_gif(levels)
        enc_s = time.perf_counter() - t0
        ok = open(backs["gif"], "rb").read() == again
        print(f"phase 18b ispec's GIF == encode_gif of the levels it writes to PPM: {ok} "
              f"({len(again)} bytes, encode {enc_s:.4f} s)", flush=True)
        if not ok:
            raise RuntimeError("phase 18b: ispec's GIF differs from encode_gif of its levels")

        # ---- (c) motion's lowpass on a GIF sequence against a PPM one ----
        mh, mw = motion_hw
        strip = _rgb8(_seeded_pixels((mh, mw + 4 * frames), 23))
        enc_s = dec_s = 0.0
        for k in range(frames):
            t0 = time.perf_counter()
            data = gif.encode_gif(np.ascontiguousarray(strip[:, 4 * k:4 * k + mw]))
            enc_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.gif"), "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            dec = gif.decode_gif(data)[0]
            dec_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(dec))
        print(f"phase 18c {frames} frames {mw}x{mh}: GIF encode {enc_s:.3f} s, decode "
              f"{dec_s:.3f} s", flush=True)
        runs = {}
        for src in ("ppm", "gif"):
            t0 = time.perf_counter()

            def run(src=src):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{src}"),
                                    os.path.join(tmp, f"o_{src}.y4m")])
                if rc != 0:
                    raise RuntimeError(f"phase 18c motion {src} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, runs[src] = count.run(run, into=src == "gif")
            print(f"phase 18c motion {src} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches "
                  f"{json.dumps(runs[src])}", flush=True)
        ok = same(os.path.join(tmp, "o_gif.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 18c GIF sequence == PPM sequence to y4m: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 18c: the GIF sequence's y4m differs from the PPM's")
        if runs["gif"] != runs["ppm"] or not runs["gif"].get("right3"):
            raise RuntimeError(f"phase 18c: launches {runs['gif']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"gif {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 18 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 19: TIFF layouts and sample formats, and CMYK JPEG (io/imgcodecs.py,
# io/jpeg.py) ---------------------------------------------------------------------
# (a): the TIFFs tests/torch_codec_fixtures.py:layout_tiffs() writes by hand
# (no Pillow): the sha256 of the JAX package's read_image(..., "RGBA") float64
# pixels of each (Pillow's decode); the CMYK JPEG fixtures of tests/goldens/
# (torch_codec_fixtures.cmyk_fixtures): the sha256 of each file and of Pillow's
# convert("RGB") of it; the 4K files' decodes: Pillow's convert("RGB") of the
# tiled CMYK TIFF and its I-mode samples of the I;32S one.  tests/test_torch_tiff.py
# and test_torch_jpeg.py pin all of them to Pillow.
LAYOUT_TIFF_DIGESTS = {
    "tiled LZW RGB predictor 2": "32be6c7b772103e46c6ea6ceb4dda584e0dad6fe2f38f966cb95ee07292f24d9",
    "planar deflate RGBA;16": "96602767c8470f9857020d1cae354d4c8831465a115ed02170615f658767ff01",
    "FillOrder 2 1 raw": "460b7eab1571ed1af068bae10706bcee3c5759e8958f596c4e12f78f1eba7bd4",
    "FillOrder 2 1 LZW": "460b7eab1571ed1af068bae10706bcee3c5759e8958f596c4e12f78f1eba7bd4",
    "FillOrder 2 L raw": "9c67728fee5ed329be34d34fcf88f4202a635213a9881f6346485c004506f5b0",
    "FillOrder 2 L LZW": "9c67728fee5ed329be34d34fcf88f4202a635213a9881f6346485c004506f5b0",
    "predictor 3 deflate F": "995b2c9a9e35a3e323250bebba9698c772b9402e6db9dab179b06c4db53f2748",
    "CMYK raw": "7b6f776aa744dc3d67fdbfda5007a9d3fc5f04eaebbfe61f7d838d296d0f85da",
    "CMYK;16 LZW big-endian": "63b49d2e26a6ec8f321390efd5e97a5c994731a450dee484d878fecf8bb28608",
    "I;32S deflate": "c138d78d3048f0f416a61f3a4407dd39b429d1ae28646004afbabd1b7164d57f",
    "4-bit palette PackBits": "64e434f4b8dec86f4c3508ef41543ab5469f3210e9257c1c34b82e77caa50848",
    "PA LZW": "d6b13311e475fb3682ab705d464ee49f612682da769966a0a98e95ae2ee2163e",
    "Orientation 6 RGB": "4f1441f967740366e2fbfb189972c5d1960c935b11b953303a3011b2463a5dc3",
    "Orientation 8 RGB tiled": "bc3812ac6638459cb24885e80345e126ffa4e56293ca7f8db7b1381e5913909c",
}
CMYK_FIXTURES = {
    "cmyk_prog_4k.jpg": ("2ef551bafb5f95e7133636568cacff55b96001b1198aa7bc8fb538b19f564cab",
                         "d9b3712e02ad4cb0c15529312954ad7340f65ef19e83e0e5fc7b6c2199f9b0f1"),
    "cmyk_rst.jpg": ("3cda68338aaa01236988af5c5251059b085999ff346a7adeaf9f0eee8e1e316d",
                     "c8571490fbaedd120e6a33d43eb54f763b9df522489ff91c9607403c2233cb76"),
    "cmyk_ycck.jpg": ("e5d28f78cc5a1adc9561118d83eecdfef2c59789ffcd24f167abc974bfc5d2c0",
                      "6116f06f87d8206f4fead8349479f923ffb169039231d669e729a26e94b81002"),
    "cmyk_no_adobe.jpg": ("7a3deb6bc4ae2e12fe5a467ba91d41edb3962ac57feefb5270f25317d2aaa482",
                          "c8571490fbaedd120e6a33d43eb54f763b9df522489ff91c9607403c2233cb76"),
}
TIFF_4K_DIGESTS = {"cmyk": "44397006abd5cf6eb1eabc0d4984e689fb972af9566c6602e7a98829965dff0c",
                   "i32": "0822a771adb5b13f156dbfb47f4369cbbd0b359a3fc79ef263e384a6809043f6"}
TIFF_4K_TILE = (256, 256)
TIFF_CMYK_FRAMES = 8              # (c): motion's lowpass on 8 1080p planar CMYK TIFF frames
                                  # (16 took the phase to 122 s alone, cold plans)


def _i32_levels(rgb8) -> np.ndarray:
    """The 4K I;32S samples: the red level * 1000 - 100000 (past 0 and
    65535 both ways)."""
    return rgb8[..., :1].astype(np.int32) * 1000 - 100000


def _tiff_cmyk_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, big=CODEC_4K,
                     motion_hw=(MH, MW), frames=TIFF_CMYK_FRAMES, device_args=(),
                     jpeg_4k="cmyk_prog_4k.jpg") -> dict:
    """Main path 15: TIFF layouts and sample formats, and CMYK JPEG,
    through the port's own codecs.  (a) Small TIFFs written by hand
    (tiles, planes, FillOrder 2, predictors 2 and 3, CMYK, I;32S, a 4-bit
    palette, PA, Orientation 6 and 8) and the CMYK JPEG fixtures (CMYK,
    YCCK, no Adobe marker, progressive) decoded, each equal to Pillow's
    digests; a 4K tiled deflate CMYK TIFF with predictor 2 and a 4K I;32S
    TIFF written and decoded, each to Pillow's digest.  (b) spec of the
    4K CMYK TIFF, the CMYK JPEG ``jpeg_4k`` and the I;32S TIFF at
    ``i8@1e-5``, each against the same pixels given as a 16-bit PNG (the
    I file, whose values run past [0, 1], against its float pixels handed
    to the tool).  (c) motion's lowpass on a 1080p tiled, planar,
    deflate CMYK TIFF sequence (Orientation 1) to y4m against a PPM
    sequence of its decoded frames.  Returns the kernels' launches over
    the CMYK and I runs."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, jpeg
    from dspfun_tpu_torch.tools import motion, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg._load()
    imgcodecs._tiff_lib()
    print(f"phase 19 libjpeg and libtiff build and load: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiff_cmyk_") as tmp:
        # ---- (a) small TIFFs and the CMYK JPEGs to Pillow's digests; 4K decodes ----
        t0 = time.perf_counter()
        small = fx.layout_tiffs()
        print(f"phase 19a {len(small)} small TIFFs written by hand in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        path = os.path.join(tmp, "small.tif")
        for name, data in small.items():
            if images._decoder(data) is not imgcodecs.decode_tiff:
                raise RuntimeError(f"phase 19a: {name} does not take the port's codec")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            ok = fx.rgba_digest(img.pixels) == LAYOUT_TIFF_DIGESTS[name]
            print(f"phase 19a TIFF {name} {img.width}x{img.height}: {len(data)} bytes, depth "
                  f"{img.depth}; read {dec_s:.4f} s; pixels == Pillow's digest: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 19a: TIFF {name} is not Pillow's: "
                                   f"{fx.rgba_digest(img.pixels)}")
        for name, want in CMYK_FIXTURES.items():
            with open(os.path.join(gold, name), "rb") as f:
                data = f.read()
            if images._decoder(data) is not jpeg.decode_jpeg:
                raise RuntimeError(f"phase 19a: {name} does not take the port's codec")
            t0 = time.perf_counter()
            arr, _ = jpeg.decode_jpeg(data)
            dec_s = time.perf_counter() - t0
            got = (sha(data), sha(np.ascontiguousarray(arr).tobytes()))
            h, w = arr.shape[:2]
            print(f"phase 19a {name} {w}x{h}: {len(data)} bytes; decode {dec_s:.4f} s "
                  f"({h * w * 4 / 1e6 / dec_s:.1f} MB/s of CMYK); file and pixels == Pillow's "
                  f"digests: {got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 19a: {name} is not Pillow's: {got}")
        (bh, bw), seed, noise = big
        rgb8 = _rgb8(_seeded_pixels((bh, bw), seed, noise))
        sources = {"cmyk_tif": os.path.join(tmp, "cmyk_4k.tif"),
                   "cmyk_jpg": os.path.join(gold, jpeg_4k),
                   "i32_tif": os.path.join(tmp, "i32_4k.tif")}
        for key, kind, samples, kw in (
                ("cmyk", "CMYK", fx.cmyk_levels(rgb8), dict(compression=8, predictor=2,
                                                          tile=TIFF_4K_TILE)),
                ("i32", "I;32S", _i32_levels(rgb8), dict(compression=8, rows_per_strip=64))):
            t0 = time.perf_counter()
            data = fx.make_tiff(samples, kind, **kw)
            enc_s = time.perf_counter() - t0
            with open(sources[f"{key}_tif"], "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            arr, depth = imgcodecs.decode_tiff(data)
            dec_s = time.perf_counter() - t0
            if (bh, bw) == (H, W):
                ok = sha(np.ascontiguousarray(arr).tobytes()) == TIFF_4K_DIGESTS[key]
            else:       # a rehearsal at another size: the samples Pillow gives for them
                ok = np.array_equal(arr, imgcodecs._cmyk_rgb(samples) if key == "cmyk" else samples)
            print(f"phase 19a {kind} TIFF {bw}x{bh} ({kw}): {len(data)} bytes, written in "
                  f"{enc_s:.3f} s; decode {dec_s:.4f} s ({samples.nbytes / 1e6 / dec_s:.1f} "
                  f"MB/s of samples), depth {depth}; pixels == Pillow's digest: {ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"phase 19a: the 4K {kind} TIFF decodes to other pixels")

        # ---- (b) spec and ispec of the three against the same pixels -----------
        read_image = images.read_image
        for ext, src in sources.items():
            pix = read_image(src).pixels
            sh, sw = pix.shape[:2]
            # the H contraction goes left and the W one right, each from 256 on
            spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
            if ext == "i32_tif":
                want = np.repeat(_i32_levels(rgb8) / 65535.0, 3, axis=2)
                ok = np.array_equal(pix, want) and pix.min() < 0 and pix.max() > 1
                print(f"phase 19b I;32S pixels == samples / 65535 (past [0, 1]: "
                      f"{pix.min():.4f} .. {pix.max():.4f}): {ok}", flush=True)
                if not ok:
                    raise RuntimeError("phase 19b: the I;32S TIFF's pixels are not samples / 65535")
                ref = os.path.join(tmp, "float_ref.tif")      # its read is handed the pixels
                shutil.copyfile(src, ref)
            else:
                ref = os.path.join(tmp, f"ref_{ext}.png")
                images.write_image(ref, pix, depth=16)

            def float_read(spec_, channels="RGB", linear=False, ref=ref, pix=pix):
                if spec_ != ref:
                    return read_image(spec_, channels=channels, linear=linear)
                return images.ImageData(pixels=pix.copy(), channels=channels, depth=16)

            policy = tag = "i8@1e-5"
            out = {k: os.path.join(tmp, f"{k}_{ext}_{tag}.png") for k in ("ref", "src")}
            with _policy(policy):
                for name, inp in (("ref", ref), ("src", src)):
                    fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                        torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o],
                        int8mm)
                    if ext == "i32_tif":
                        images.read_image = float_read
                    try:
                        (wall, stages, got), _ = count.run(fn, into=name == "src")
                    finally:
                        images.read_image = read_image
                    what = f"spec {ext} {name}"
                    print(f"phase 19b {what} {sw}x{sh} at {tag}: {wall:.3f} s; stages "
                          f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                    if got != spec_i8:
                        raise RuntimeError(f"phase 19b {what} at {tag} launched {got}, "
                                           f"expected {spec_i8}")
            ok = same(out["ref"], out["src"])
            print(f"phase 19b {ext} at {tag}: spectrum == the "
                  f"{'float pixels' if ext == 'i32_tif' else '16-bit PNG'} route's: {ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"phase 19b at {tag}: the {ext} route differs")

        # ---- (c) motion's lowpass on a planar CMYK TIFF sequence against PPM ----
        mh, mw = motion_hw
        strip = _rgb8(_seeded_pixels((mh, mw + 4 * frames), 25))
        enc_s = dec_s = 0.0
        for k in range(frames):
            cmyk = fx.cmyk_levels(np.ascontiguousarray(strip[:, 4 * k:4 * k + mw]))
            t0 = time.perf_counter()
            data = fx.make_tiff(cmyk, "CMYK", compression=8, tile=TIFF_4K_TILE, planar=True,
                                extra_tags={274: (3, [1])})
            enc_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.tif"), "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            dec = imgcodecs.decode_tiff(data)[0]
            dec_s += time.perf_counter() - t0
            if not np.array_equal(dec, imgcodecs._cmyk_rgb(cmyk)):
                raise RuntimeError(f"phase 19c: TIFF frame {k} decodes to other pixels")
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(dec))
        print(f"phase 19c {frames} frames {mw}x{mh}: planar tiled deflate CMYK TIFF write "
              f"{enc_s:.3f} s, decode {dec_s:.3f} s ({frames * mh * mw * 4 / 1e6 / dec_s:.1f} "
              "MB/s of CMYK)", flush=True)
        runs = {}
        for src in ("ppm", "tif"):
            t0 = time.perf_counter()

            def run(src=src):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{src}"),
                                    os.path.join(tmp, f"o_{src}.y4m")])
                if rc != 0:
                    raise RuntimeError(f"phase 19c motion {src} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, runs[src] = count.run(run, into=src == "tif")
            print(f"phase 19c motion {src} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches "
                  f"{json.dumps(runs[src])}", flush=True)
        ok = same(os.path.join(tmp, "o_tif.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 19c CMYK TIFF sequence == PPM sequence to y4m: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 19c: the TIFF sequence's y4m differs from the PPM's")
        if runs["tif"] != runs["ppm"] or not runs["tif"].get("right3"):
            raise RuntimeError(f"phase 19c: launches {runs['tif']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"tiff_cmyk {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 19 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 20: JPEG-in-TIFF, YCbCr, CCITT fax, CIELab TIFF (io/imgcodecs.py,
# io/jpeg.py, native/fax.cpp, native/tiff.cpp) ------------------------------------
# (a): the TIFFs tests/torch_codec_fixtures.py:more_tiffs() writes by hand (no
# Pillow): the sha256 of the JAX package's read_image(..., "RGBA") float64
# pixels of each (Pillow's decode); Pillow's JPEG-in-TIFF goldens of
# tests/goldens/ (torch_codec_fixtures.tiff_jpeg_goldens): the sha256 of each
# file and of the JAX package's RGBA read of it; (b): Pillow's convert("RGB")
# of each 4K file of torch_codec_fixtures.tiff_4k.  tests/test_torch_tiff_more.py
# pins all of them to Pillow.
MORE_TIFF_DIGESTS = {
    "JPEG YCbCr 4:2:0 tiled": "1917235ed0e2481fac88efaa36241a14b3c64e1df4a6336e013b9d29e5817fa7",
    "YCbCr 2x2 LZW ReferenceBlackWhite":
        "20faae5529ce41dec532f81be35c89da2c7b1ccade705afaaec62a6b2e6419f2",
    "YCbCr 4x2 LZW ReferenceBlackWhite":
        "3b67f662e8752358cd927aecc54b9b3d3422dc2fd5a38c05b645f04deb310450",
    "G3 1-D": "a8e14d7ccc2acb46a9e53cb78ac1a98faf5da61576f3b1d9ac0f2f1919e2ba30",
    "G3 2-D EOL fill": "df0de68a80935a6ece1fee9d4a646aee2e0abf53172fb938841586877db29aa2",
    "G4 FillOrder 2": "934804383a8803f02a84492b3f314fca5884dc778de43bad0c5839324d9450e0",
    "CCITT RLE": "186082e8d7a9ee8fc65a52a363e6e649e6c2781f84f546f38d49f13455ed4960",
    "LAB deflate": "c527a0ed2d5d04dc1816a3611371d00c5d8a2a02122254b8bf22c25b3b3af0bd",
    "LAB planar deflate": "59699ce901b5e0a056172fcbf34eb697011a53480ec581ed6b24eb3dd3b54a26",
}
TIFF_JPEG_FIXTURES = {
    "tiffjpeg_ycbcr11.tif": ("7243b51e8f3edd1b1d4391979d17ae6d083ee4d2b74acf165277ca4aa08c6672",
                             "02bddf1baa8b7eff5e9ac431c45fca867472224f0587004af2252af892f9ed39"),
    "tiffjpeg_rgb.tif": ("6f237356b83fa0b562e24155730d1177b3c211467b6045d3a37702845a24b7ee",
                         "5e16122b78e5c743cc93006ef06bb1d1d0302d21018d399c61d271ad601a844d"),
    "tiffjpeg_gray.tif": ("072d1b1966e463537bb46dc6dfd215afe2b1369b2e045957a0e9a28aa540ef6a",
                          "a2ab6b7da301b75097ba5bba96f1fcc95dd1d86f8f839373b5aa6134aff1902a"),
    "tiffjpeg_cmyk.tif": ("6db43aa924299ee2443fc7ec4fb2cccead12ec8d82655253aee5aff81207d007",
                          "890e987f48fdff1c4459b05412376ff89e31fe2ef446d2093a16367b2fb8ab2b"),
}
TIFF_MORE_4K_DIGESTS = {
    "jpeg": "267aca3c538ce990fba07f616359e10a0a28bdc78ad7cfb27e4adc80ecd4c291",
    "g4": "ccccb0eb8412a85af82089972b37aac81b5d8d90e38e462f79132ed224597bbe",
    "ycbcr": "3078292f10383b8d703387f140f45f553700cdd10a43639dc0f142e14d2a2bbc",
}
TIFF_MORE_FRAMES = 8              # (d): motion's lowpass on 8 1080p JPEG-in-TIFF frames
TIFF_MORE_ROWS = 16               # their strips: one MCU row of 4:2:0


def _tiff_more_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, big=CODEC_4K,
                     motion_hw=(MH, MW), frames=TIFF_MORE_FRAMES, device_args=()) -> dict:
    """Main path 16: JPEG-in-TIFF, YCbCr, CCITT fax and CIELab TIFF
    through the port's own codecs.  (a) Small TIFFs written by hand (tiled
    4:2:0 JPEG-in-TIFF, YCbCr LZW at 2x2 and 4x2 with a
    ReferenceBlackWhite, G3 1-D, G3 2-D with EOL fill bits, G4 in
    FillOrder 2, CCITT RLE, CIELab deflate chunky and planar) and
    Pillow's JPEG-in-TIFF goldens (YCbCr at 1x1 in 8-row strips, RGB,
    gray, CMYK), each read to Pillow's digest; (b) a 3840x2160 tiled
    4:2:0 JPEG-in-TIFF, a G4 page and a YCbCr 2x2 deflate TIFF written
    and decoded, each to Pillow's digest, with seconds and MB/s; (c)
    spec of the JPEG-in-TIFF and the G4 page at ``i8@1e-5``, each against
    the same pixels given as a 16-bit PNG; (d) motion's lowpass on a 1080p
    JPEG-in-TIFF sequence (4:2:0 in strips of 16 rows) to y4m against a
    PPM sequence of its decoded frames.  Returns the kernels' launches
    over the JPEG-in-TIFF and fax runs."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, jpeg
    from dspfun_tpu_torch.tools import motion, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg._load()
    imgcodecs._tiff_lib()
    imgcodecs._fax_lib()
    print(f"phase 20 libjpeg, libtiff and libfax build and load: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiff_more_") as tmp:
        # ---- (a) small TIFFs and Pillow's JPEG-in-TIFF goldens to Pillow's digests ----
        t0 = time.perf_counter()
        small = fx.more_tiffs()
        print(f"phase 20a {len(small)} small TIFFs written by hand in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        path = os.path.join(tmp, "small.tif")
        cases = [(name, data, None, MORE_TIFF_DIGESTS[name]) for name, data in small.items()]
        for name, (file_sha, want) in TIFF_JPEG_FIXTURES.items():
            with open(os.path.join(gold, name), "rb") as f:
                cases.append((name, f.read(), file_sha, want))
        for name, data, file_sha, want in cases:
            if images._decoder(data) is not imgcodecs.decode_tiff:
                raise RuntimeError(f"phase 20a: {name} does not take the port's codec")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            ok = fx.rgba_digest(img.pixels) == want and file_sha in (None, sha(data))
            print(f"phase 20a TIFF {name} {img.width}x{img.height}: {len(data)} bytes, depth "
                  f"{img.depth}; read {dec_s:.4f} s; file and pixels == Pillow's digests: {ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"phase 20a: TIFF {name} is not Pillow's: "
                                   f"{sha(data)} {fx.rgba_digest(img.pixels)}")

        # ---- (b) the 4K files: write, decode, Pillow's digests --------------------
        (bh, bw), seed, noise = big
        sources, dec_times = {}, {}
        for kind, what in (("jpeg", "tiled 4:2:0 JPEG-in-TIFF"), ("g4", "G4 page"),
                           ("ycbcr", "YCbCr 2x2 deflate")):
            t0 = time.perf_counter()
            data = fx.tiff_4k(kind, (bh, bw), seed, noise)
            enc_s = time.perf_counter() - t0
            sources[kind] = os.path.join(tmp, f"{kind}_4k.tif")
            with open(sources[kind], "wb") as f:
                f.write(data)
            if images._decoder(data) is not imgcodecs.decode_tiff:
                raise RuntimeError(f"phase 20b: the 4K {what} does not take the port's codec")
            t0 = time.perf_counter()
            arr, depth = imgcodecs.decode_tiff(data)
            dec_s = dec_times[kind] = time.perf_counter() - t0
            rgb = np.repeat(arr, 3, axis=2) if arr.shape[2] == 1 else arr    # gray as RGB
            got = sha(np.ascontiguousarray(rgb).tobytes())
            if (bh, bw) == (H, W):
                ok = got == TIFF_MORE_4K_DIGESTS[kind]
            else:       # a rehearsal at another size: no digest to hold it to
                ok = arr.shape[:2] == (bh, bw)
            print(f"phase 20b {what} {bw}x{bh}: {len(data)} bytes, written in {enc_s:.3f} s; "
                  f"decode {dec_s:.4f} s ({bh * bw * 3 / 1e6 / dec_s:.1f} MB/s of RGB, "
                  f"{len(data) / 1e6 / dec_s:.1f} MB/s of file), depth {depth}; pixels == "
                  f"Pillow's digest: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 20b: the 4K {what} decodes to other pixels ({got})")

        # ---- (c) spec and ispec of the JPEG-in-TIFF and the G4 page ---------------
        read_image = images.read_image
        for ext in ("jpeg", "g4"):
            src = sources[ext]
            pix = read_image(src).pixels
            sh, sw = pix.shape[:2]
            spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
            ref = os.path.join(tmp, f"ref_{ext}.png")
            images.write_image(ref, pix, depth=16)
            policy = tag = "i8@1e-5"
            out = {k: os.path.join(tmp, f"{k}_{ext}_{tag}.png") for k in ("ref", "src")}
            with _policy(policy):
                for name, inp in (("ref", ref), ("src", src)):
                    fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                        torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o],
                        int8mm)
                    (wall, stages, got), _ = count.run(fn, into=name == "src")
                    what = f"spec {ext} {name}"
                    print(f"phase 20c {what} {sw}x{sh} at {tag}: {wall:.3f} s; stages "
                          f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                    if got != spec_i8:
                        raise RuntimeError(f"phase 20c {what} at {tag} launched {got}, "
                                           f"expected {spec_i8}")
            ok = same(out["ref"], out["src"])
            print(f"phase 20c {ext} at {tag}: spectrum == the 16-bit PNG route's: {ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"phase 20c at {tag}: the {ext} route differs")

        # ---- (d) motion's lowpass on a JPEG-in-TIFF sequence against PPM ----------
        mh, mw = motion_hw
        strip = _rgb8(_seeded_pixels((mh, mw + 4 * frames), 26))
        enc_s = dec_s = 0.0
        for k in range(frames):
            rgb = np.ascontiguousarray(strip[:, 4 * k:4 * k + mw])
            t0 = time.perf_counter()
            data = fx.make_tiff(rgb, "YCbCr", compression=7, rows_per_strip=TIFF_MORE_ROWS)
            enc_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.tif"), "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            dec = imgcodecs.decode_tiff(data)[0]
            dec_s += time.perf_counter() - t0
            rms = float(np.sqrt(np.mean((dec.astype(np.float64) - rgb) ** 2)))
            if dec.shape != rgb.shape or rms > 24:     # quality 75 of noisy levels: about 14
                raise RuntimeError(f"phase 20d: TIFF frame {k} decodes to {dec.shape}, rms "
                                   f"{rms:.2f} levels from its samples")
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(dec))
        print(f"phase 20d {frames} frames {mw}x{mh}: 4:2:0 JPEG-in-TIFF in strips of "
              f"{TIFF_MORE_ROWS} rows, write {enc_s:.3f} s, decode {dec_s:.3f} s "
              f"({frames * mh * mw * 3 / 1e6 / dec_s:.1f} MB/s of RGB)", flush=True)
        runs = {}
        for src in ("ppm", "tif"):
            target = os.path.join(tmp, f"o_{src}.y4m")
            t0 = time.perf_counter()

            def run(src=src, target=target):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{src}"), target])
                if rc != 0:
                    raise RuntimeError(f"phase 20d motion {src} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, got = count.run(run, into=src == "tif")
            runs[src] = got
            print(f"phase 20d motion {src} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches {json.dumps(got)}",
                  flush=True)
        ok = same(os.path.join(tmp, "o_tif.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 20d JPEG-in-TIFF sequence == PPM sequence to y4m: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 20d: the TIFF sequence's y4m differs from the PPM's")
        if runs["tif"] != runs["ppm"] or not runs["tif"].get("right3"):
            raise RuntimeError(f"phase 20d: launches {runs['tif']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"tiff_jpeg {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 20 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    # for phase 28: the 4K JPEG-in-TIFF's decode seconds
    return {"launches": count.total, "shapes": sorted(count.shapes),
            "jpeg_4k_decode_s": dec_times.get("jpeg")}


# phase 21: WebP through the port's own decoder (io/webp.py, native/webp.cpp) -------
# The WebP fixtures of tests/goldens/ (tests/torch_codec_fixtures.py:webp_fixtures):
# the sha256 of each file and of the JAX package's read_image(..., "RGBA") float64
# pixels of it (Pillow's decode).  tests/test_torch_webp.py pins them to Pillow.
WEBP_FIXTURES = {
    "webp_lossy.webp": ("7c4266d534468aba5b5d35ff704bc930c88fe541a0676812aa85e450245f151f",
                       "691939cbbd2a94768bac8974898e7135cfefde233f64d721826b68832ab93025"),
    "webp_lossy_q100_m6.webp": ("0b4682d020bde6a0a2e854a9f38a0f78a377047500b411034092b6d3e6b0e8bc",
                               "4aeee6aa77437427788bb9d335894b6d974247fb28018e91e1aed59d4df5a5de"),
    "webp_lossy_alpha.webp": ("22b0575868bc6d851cfb0f57ed538c93fb175928ed7d25ffb24af59a974c4467",
                             "e870cc1639c8c579ba0d831855ddba35830add7867b832ae8e81a0798d43445f"),
    "webp_lossless.webp": ("d65dea2e8965a35a3445cdefd1b340c57496742a2b45da06dfe147aa23f2caa8",
                          "bd9bac46cea0d610db4b1366e742f3edccc52d2526fe59e77194ad62bf323d42"),
    "webp_lossless_alpha.webp": ("0f881ff708314ee7168c011a33a993e8f4460af0266fc818ec9fa4e8083fe62e",
                                "0884f0d0555d3263d94b46ea78c0603d2d9cab3a2700cae32480216df670bc11"),
    "webp_palette16.webp": ("a5c774ad837bd3bedefbc167d08bc6772c354a060aed31f8ecfd34562a6a194f",
                           "144ee0f338893e62eaedd885c4b3876f8b97ad5147b91ef89c0b65d674c83cdc"),
    "webp_anim.webp": ("4e7d4587ad2980490e1d1a847fc79bdd1409ba8855acfbcc6ce7799f49d45967",
                      "0759c5074efcfb2e34f12a790775d4c7113c2b789ed2a6b7eacdf173da16698d"),
    "webp_hand_raw_alph.webp": ("08366852dac73c35e66ffbcb735c067ca7f58e8315b53dace15bb377d97fbe5a",
                               "69a4f7a6479979c9aa96a1d5ef8299af1a70e145a91a054733b9987f8118a9e1"),
    "codec_webp_4k.webp": ("2161b336d36b588d940d467d324d9f2456e23869c6de14bda2adbdb5f8903fec",
                          "db44f77ea613e7cbef5f93a5a211ef420ea7d63bbe847b91796affe5c91c2011"),
    "webp_motion0000.webp": ("fe6cecf7d3e4f7615f5f4607d23aab17ea41f590c3eb229dfa71bc9b03dae5c0",
                            "3bc282816f2dea5302a424c9f2bb44f3d31865f8c6497b2a93c886480fcee9df"),
    "webp_motion0001.webp": ("4a8e20f54ed1b79e84eef789bd351713129300956c80c0cc3eddddb240211e65",
                            "b15014613e04232cad046f226c67bd0234eb140b409dfac0179092908eac925e"),
    "webp_motion0002.webp": ("1e1e4ad36ad0620b7e6fa25f39498a7a93a86f83920e22267663c9fc01bf1ae9",
                            "4afaea4f902a9bfc54ba54693fb38517e56fed7ef6084479cda40046417ddd50"),
    "webp_motion0003.webp": ("7beaeaf627796426f2def864f1aec1b5bf4e3eadd8fefef0c2fc5faa36d95df0",
                            "be44421a410f4d5494d691f7bc40192859ad6758711a467e4fc1c60fa991d321"),
    "webp_motion0004.webp": ("f635e6435121d4037e5ce49cb7fa136f38e4eaba9f3d397b274bc7644e4a0618",
                            "20a312c2b5e391dc84445fef696af92274abbfece6614563c0ae4edce6c69406"),
    "webp_motion0005.webp": ("e23434a944716785ae0c73d603f74e47bafc51025d185343031979c1af42ad30",
                            "1caec465a739858583767e46c89394639efe2f7fcea31eb2cd8b715f9108305c"),
    "webp_motion0006.webp": ("7e8b6ebfa91bd6455b5a3d685e85b89b45a935447805d27fa993bcfaa01c05a4",
                            "f102380adfdc551019cf6a6c5bd6821df33a66ab7fbdc1213f14e38d773c83f6"),
    "webp_motion0007.webp": ("3c528034d62b660285c3ef1922e17f187a6c1786830ab803d310299f61675ffc",
                            "7aa0036cd9e9b524af78b237dccab2494fb8c6cb10051c3f798ab8a00f119ea5"),
}
WEBP_FRAMES = 8                   # (c): motion's lowpass on the 8 1080p WebP frames
WEBP_REPEATS = 3                  # (b): the 4K decode, best of


def _webp_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, frames=WEBP_FRAMES,
                device_args=()) -> dict:
    """Main path 17: WebP through the port's own decoder.  (a) The WebP
    fixtures of tests/goldens/, each read to the JAX package's digests;
    (b) the 4K file decoded (best of ``WEBP_REPEATS``, seconds and MB/s),
    spec of it at ``i8@1e-5`` against the same pixels given as a PNG; (c)
    motion's lowpass on the 1080p WebP frames to y4m against a PPM
    sequence of their decoded frames.  Returns the kernels' launches over
    the WebP runs."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, webp
    from dspfun_tpu_torch.tools import motion, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    webp._load()
    print(f"phase 21 libwebp (native/webp.cpp) build and load: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_webp_") as tmp:
        # ---- (a) the fixtures to the JAX package's digests -------------------------
        for name, want in WEBP_FIXTURES.items():
            path = os.path.join(gold, name)
            with open(path, "rb") as f:
                data = f.read()
            if images._decoder(data) is not webp.decode_webp:
                raise RuntimeError(f"phase 21a: {name} does not take the port's decoder")
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            got = (sha(data), fx.rgba_digest(img.pixels))
            print(f"phase 21a WebP {name} {img.width}x{img.height}: {len(data)} bytes; read "
                  f"{dec_s:.4f} s; file and pixels == the JAX package's digests: "
                  f"{got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 21a: WebP {name} is not Pillow's: {got}")

        # ---- (b) the 4K file: decode, spec and ispec against a PNG of its pixels ---
        src = os.path.join(gold, "codec_webp_4k.webp")
        with open(src, "rb") as f:
            data = f.read()
        best = float("inf")
        for _ in range(WEBP_REPEATS):
            t0 = time.perf_counter()
            arr, _ = webp.decode_webp(data)
            best = min(best, time.perf_counter() - t0)
        bh, bw = arr.shape[:2]
        print(f"phase 21b WebP {bw}x{bh}: {len(data)} bytes; decode {best:.4f} s (best of "
              f"{WEBP_REPEATS}; {bh * bw * 3 / 1e6 / best:.1f} MB/s of RGB, "
              f"{len(data) / 1e6 / best:.2f} MB/s of file)", flush=True)
        pix = images.read_image(src).pixels
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, pix)
        spec_i8 = {n: 1 for n, side in (("left3", bh), ("right3", bw)) if side >= 256}
        policy = tag = "i8@1e-5"
        out = {k: os.path.join(tmp, f"{k}_{tag}.png") for k in ("ref", "webp")}
        with _policy(policy):
            for name, inp in (("ref", ref), ("webp", src)):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o],
                    int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "webp")
                print(f"phase 21b spec {name} {bw}x{bh} at {tag}: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 21b spec {name} at {tag} launched {got}, "
                                       f"expected {spec_i8}")
        ok = same(out["ref"], out["webp"])
        print(f"phase 21b at {tag}: spectrum from the WebP == from the PNG: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"phase 21b at {tag}: the WebP route differs from the PNG's")

        # ---- (c) motion's lowpass on the WebP frames against a PPM sequence -------
        dec_s = 0.0
        for k in range(frames):
            name = f"webp_motion{k:04d}.webp"
            with open(os.path.join(gold, name), "rb") as f:
                data = f.read()
            shutil.copy(os.path.join(gold, name), os.path.join(tmp, f"in{k:04d}.webp"))
            t0 = time.perf_counter()
            dec = webp.decode_webp(data)[0]
            dec_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(dec))
        mh, mw = dec.shape[:2]
        print(f"phase 21c {frames} WebP frames {mw}x{mh}: decode {dec_s:.3f} s "
              f"({frames * mh * mw * 3 / 1e6 / dec_s:.1f} MB/s of RGB)", flush=True)
        runs = {}
        for src in ("ppm", "webp"):
            target = os.path.join(tmp, f"o_{src}.y4m")
            t0 = time.perf_counter()

            def run(src=src, target=target):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{src}"), target])
                if rc != 0:
                    raise RuntimeError(f"phase 21c motion {src} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, got = count.run(run, into=src == "webp")
            runs[src] = got
            print(f"phase 21c motion {src} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches {json.dumps(got)}",
                  flush=True)
        ok = same(os.path.join(tmp, "o_webp.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 21c WebP sequence == PPM sequence to y4m: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 21c: the WebP sequence's y4m differs from the PPM's")
        if runs["webp"] != runs["ppm"] or not runs["webp"].get("right3"):
            raise RuntimeError(f"phase 21c: launches {runs['webp']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"webp {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 21 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


OTHER_FIXTURES = {
    "tga_rgb.tga": ("f32a368243bfa06766b65c217b7128d50a98ec2adcd954ffbd17d02a8f394160",
                  "1ed380322b2680d67bbb422c4a5307e64d503b301e6881d0da7faabff7c22f64"),
    "tga_rgba_rle_top.tga": ("48741bf1fb8add5044d2344b00fa4926433a792136f5895ca2484b1bd826ebea",
                           "fb998ab814175eb1e56210714c1bcd9e4204ef906d55c1534390d901e5f4328a"),
    "tga_rgb_rle_flip.tga": ("6443ef652fb54c302e2209cae7dbb6da34c6261056a2a1040c73bad7e1837805",
                           "1ed380322b2680d67bbb422c4a5307e64d503b301e6881d0da7faabff7c22f64"),
    "tga_rgb_top_right.tga": ("ab36ac2f9fedae9eb472e76aac9fe41a5a934d332226f450a32c89602988f81c",
                            "bac596043bc03cc18beb0b90bfebde3158277c00e46a5eb836070385ed93aa0f"),
    "tga_16bit.tga": ("9865cbef15480fd6c2561503f2f2c2776a50d81060811d85c700ad709d90e243",
                    "36de773b95d684e6d3def97256a37fc66f02c49da4cdbb0fecaeb1a8e4b6706c"),
    "tga_cmap_rle.tga": ("eadf0bd5eb2e2db52a97e5d1def526579f9b22b1ca93b8b9d45c2ffc5a99ff4b",
                       "44712aea5f6f1eb6eee18260a87abe1afaec66f876bcdd26782b88d580f2b224"),
    "tga_cmap16.tga": ("e7d29618c4fb4ca0380c3ac19018fe9e0a187ad984561d55082505af3e65e07f",
                     "0f61ef167845b3ef50f8f008c3c4f856caa384a4b18bae66268f0dc973023b2a"),
    "tga_gray_rle.tga": ("306e7ac3bf74b704cb804297dec7961a5b09b0322f5a665584c0b4e5df7a2137",
                       "c565ff857efbc0b65ff2ddd295d45a59394de513a85add709b89de82eb156c63"),
    "tga_la.tga": ("882fae0b6c62c45cc33ea69a19a1ba529dfe8ab7e777b3976db95640d554a993",
                 "9b257f30a7a08cc70fc9fe248ff814d750bdb5c2aa2e336601d4f8302393af3e"),
    "tga_1bit.tga": ("3644d88c12c99d58904e3febf77ae25f4c4be8c2da77243d78a77e656cadcd57",
                   "cd116ac77b81e029783aafbdfd2cf43c14325eda7b07a4601b69f767a756cf4d"),
    "pcx_rgb.pcx": ("d7a28cfbdbbcf1da553ecea6fb83abc65f16813fee9d152a85a01641ae7c4148",
                  "bac596043bc03cc18beb0b90bfebde3158277c00e46a5eb836070385ed93aa0f"),
    "pcx_l.pcx": ("1bddc2071e65f4e442385372492a7e093cb14872803bfdf3447ed3353a85c913",
                "c565ff857efbc0b65ff2ddd295d45a59394de513a85add709b89de82eb156c63"),
    "pcx_p.pcx": ("4c942688dcef97ae6cc82baab5eb0fc2fa24c1e1b91b8427e62016a18bf5cafd",
                "44712aea5f6f1eb6eee18260a87abe1afaec66f876bcdd26782b88d580f2b224"),
    "pcx_1bit.pcx": ("4cc9343771759c371a28cf81dd80ccc58875ba2c3ab97df30a9ee4863d635775",
                   "cd116ac77b81e029783aafbdfd2cf43c14325eda7b07a4601b69f767a756cf4d"),
    "pcx_4plane.pcx": ("0f3fcc313aa923c7282db9229c495c53be833eec7197a62360fcaada438e6b5d",
                     "44712aea5f6f1eb6eee18260a87abe1afaec66f876bcdd26782b88d580f2b224"),
    "pcx_2plane.pcx": ("7e794c318e697f5ce8f224904bc7ed895981842a029a6cef1f24c6eef3c201c5",
                     "e89a9336b71c4d7103efd5a13eef2645280db631716e16010e4d7608d6700c3c"),
    "sgi_rgb.sgi": ("b0494953dab74d4ae800233a7ac1f21890fb4ec805fa2633041bb6c7738d54bc",
                  "1ed380322b2680d67bbb422c4a5307e64d503b301e6881d0da7faabff7c22f64"),
    "sgi_rgba.sgi": ("7f78855c7803c97f205022020e7cb98bec3693cdea2dc3121d072e215ff0d8ae",
                   "fb998ab814175eb1e56210714c1bcd9e4204ef906d55c1534390d901e5f4328a"),
    "sgi_l_bpc2.sgi": ("12a9601bf28fb946972412ea5156c53700691ac228fabd8c0bf074c743202f9b",
                     "c565ff857efbc0b65ff2ddd295d45a59394de513a85add709b89de82eb156c63"),
    "sgi_rle_rgb.sgi": ("00fa155f8aaf04667d66066cc0de57097ff46c6ecf89ea384593b4b4a555565e",
                      "bac596043bc03cc18beb0b90bfebde3158277c00e46a5eb836070385ed93aa0f"),
    "sgi_rle_rgba_bpc2.sgi": ("99cb2f28cd0f15b65572faff64374f50d8f978393053361785b23e611210294c",
                            "81c13b4f231cee4ab232443380d1ba4f6b1763401e026449db4b63b7ed3fdfdd"),
    "qoi_rgb.qoi": ("a9fb7be4926a6a08e75d4c30a0da21a5767cac86a73dab50ed1fcd0c224894ad",
                  "1ed380322b2680d67bbb422c4a5307e64d503b301e6881d0da7faabff7c22f64"),
    "qoi_rgba.qoi": ("04e399c047c9f8d8a178a1ceea3f1a7f849e167a81c1572f9b1ff1f71deac6f6",
                   "fb998ab814175eb1e56210714c1bcd9e4204ef906d55c1534390d901e5f4328a"),
    "im_rgb.im": ("0692c17cc1370a29288b0db678c3582a7fda3f807ce9686d7f97499d775ac010",
                "1ed380322b2680d67bbb422c4a5307e64d503b301e6881d0da7faabff7c22f64"),
    "im_l.im": ("67f7f6357ebaadb58b27b041c1641c323c17906cce026261fa74f873e7d546c1",
              "c565ff857efbc0b65ff2ddd295d45a59394de513a85add709b89de82eb156c63"),
    "im_l16.im": ("8fdf90449a7c7d61c69ce432873de25ce86c70de1146db6a8af3cedec66addd7",
                "c565ff857efbc0b65ff2ddd295d45a59394de513a85add709b89de82eb156c63"),
    "im_lut.im": ("3777f6dd4dd16756c2f9d95ef436ba8aa7031aed11d8b38eaab00c1822032b6d",
                "44712aea5f6f1eb6eee18260a87abe1afaec66f876bcdd26782b88d580f2b224"),
    "ico_png.ico": ("58bfcb3dc25cb7a51e499ebb04e34ec29e388b498dced88b0de41adce79d3930",
                  "cc85ed6515c89c9605cb8c93cb38d5ca8c689143340e6c0e409441b808b87f67"),
    "ico_bmp32.ico": ("1a702e28435cb9d0d309dce69577ad5a0dcce0a7e58834f978377792dd88db75",
                    "cc85ed6515c89c9605cb8c93cb38d5ca8c689143340e6c0e409441b808b87f67"),
    "ico_bmp8.ico": ("b15aaf399b207a658629741e0d2d133e5097c7e0626cb3fcfcb16d4435b7f11b",
                   "43f48f47171f43f316160d6826354a42b0c59b0c464e463bafa001a993c6c9ed"),
    "dib_rgb.dib": ("68f7cb9a37069bade506b858815eec73bec03fff151953d2fd907e9ddb759360",
                  "bac596043bc03cc18beb0b90bfebde3158277c00e46a5eb836070385ed93aa0f"),
    "dib_p8.dib": ("7d569f5560cda84050f858ad2fa6c792c4d4f129b46baf18bea2694b831f2477",
                 "44712aea5f6f1eb6eee18260a87abe1afaec66f876bcdd26782b88d580f2b224"),
}
OTHER_4K_SEED = 43                # (b): the 4K stills' seeded pixels, at a noise that
OTHER_4K_NOISE = 0.02             # keeps spec's 16-bit PNG write as short as phase 21's
# (b): sha256 of the JAX package's write of them (named still.<ext>), by extension
OTHER_4K_DIGESTS = {
    "tga": "be5a977750330fd79cdaea1770186f8880bb1f0e6de7939682ade3255019bfca",
    "qoi": "9fb7cc31459194927d09cab36e693f47522fd34151855e1849d201e8526c7a4c",
    "sgi": "89472e043901b3fa2d3488214edb437afeebce8e3aa429d69ab712d97748686a",
    "pcx": "e004ddcc40f54c9ddcc8942e87a06cf4947e1746d6ad6e262e4af26201758a51",
    "im": "66b7d0884cadbdc1aa0ffbdf857116444c57929a69b703dac67b9e43821f52f8",
    "ico": "7cc9a8fb27cb49d483222a024571271b3b9dd5c051384f0ec6982a5e1d3bd5f8",
    "dib": "5d9e76b19b221519ac141be0f863dc4476221293498250e7b909070f0ee94c53",
    "mpo": "2db80552a93896430e1396b6ae640cc9359e967949c909566f515d525b71c7d4",
}
OTHER_EXTS = ("tga", "qoi", "sgi", "pcx", "im", "ico", "dib", "mpo")
OTHER_ISPEC = ("tga", "ico")      # (b): ispec writes these; every one's encoder is held at 4K
OTHER_FRAMES = 8                  # (c): motion's lowpass on 8 1080p RLE TGA frames
OTHER_REPEATS = 3                 # (b): the 4K decodes, best of


def _other_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, frames=OTHER_FRAMES,
                 device_args=()) -> dict:
    """Main path 18: TGA, PCX, SGI, QOI, IM, ICO and DIB through the port's
    own codecs (``io/rawimg.py``, ``io/ico.py``, ``io/imgcodecs.py``,
    ``native/rawimg.cpp``).  (a) The fixtures of tests/goldens/, each to
    its decoder and read to the JAX package's digests; (b) a 3840x2160
    QOI (the port's encoder) and RLE TGA (``tga_rle`` of the fixtures
    module) of the same seeded levels decoded (best of
    ``OTHER_REPEATS``), spec of each at ``i8@1e-5`` against the same
    levels as a PNG, ispec at ``i8@1e-5`` to
    each format of ``OTHER_ISPEC``, each file equal to the port's encoder
    of the pixels of the same ispec written as PPM, and the 4K writes of
    ``_seeded_pixels`` in every format of ``OTHER_EXTS`` to Pillow's
    digests; (c) motion's lowpass on 1080p
    RLE TGA frames to y4m against a PPM sequence of their decoded frames.
    Returns the kernels' launches over the runs of the new formats."""
    import hashlib

    from dspfun_tpu_torch.io import ico, images, imgcodecs, rawimg
    from dspfun_tpu_torch.tools import ispec, motion, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    decoders = {"tga": rawimg.decode_tga, "pcx": rawimg.decode_pcx, "sgi": rawimg.decode_sgi,
                "qoi": rawimg.decode_qoi, "im": rawimg.decode_im, "ico": ico.decode_ico,
                "dib": imgcodecs.decode_dib}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rawimg._load()
    print(f"phase 22 native/rawimg.cpp build and load: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as tmp:
        # ---- (a) the fixtures to the JAX package's digests -------------------------
        for name, want in OTHER_FIXTURES.items():
            path = os.path.join(gold, name)
            with open(path, "rb") as f:
                data = f.read()
            ext = name.rsplit(".", 1)[1]
            if images._decoder(data) is not decoders[ext]:
                raise RuntimeError(f"phase 22a: {name} does not take the port's {ext} decoder")
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            got = (sha(data), fx.rgba_digest(img.pixels))
            print(f"phase 22a {name} {img.width}x{img.height} depth {img.depth}: {len(data)} "
                  f"bytes; read {dec_s:.4f} s; file and pixels == the JAX package's digests: "
                  f"{got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 22a: {name} is not Pillow's: {got}")

        # ---- (b) the 4K stills: decode, spec and ispec ---------------------------
        pix = _seeded_pixels((H, W), OTHER_4K_SEED, OTHER_4K_NOISE)
        lv = np.clip(np.rint(np.clip(pix, 0.0, 1.0) * 255), 0, 255).astype(np.uint8)
        stills = {"qoi": rawimg.encode_qoi(lv), "tga": fx.make_tga(lv[..., ::-1], 10, 24)}
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, pix)
        src = {}
        for kind, data in stills.items():
            src[kind] = os.path.join(tmp, f"still.{kind}")
            with open(src[kind], "wb") as f:
                f.write(data)
            best = float("inf")
            for _ in range(OTHER_REPEATS):
                t0 = time.perf_counter()
                arr, _ = decoders[kind](data)
                best = min(best, time.perf_counter() - t0)
            if not np.array_equal(arr, lv):
                raise RuntimeError(f"phase 22b: the 4K {kind} does not decode to its levels")
            print(f"phase 22b {kind.upper()} {W}x{H}: {len(data)} bytes; decode {best:.4f} s "
                  f"(best of {OTHER_REPEATS}; {H * W * 3 / 1e6 / best:.1f} MB/s of RGB, "
                  f"{len(data) / 1e6 / best:.2f} MB/s of file)", flush=True)
        spec_i8 = {n: 1 for n, side in (("left3", H), ("right3", W)) if side >= 256}
        policy = tag = "i8@1e-5"
        out = {k: os.path.join(tmp, f"{k}_{tag}.png") for k in ("ref", *stills)}
        with _policy(policy):
            for name, inp in (("ref", ref), *src.items()):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o],
                    int8mm)
                (wall, stages, got), _ = count.run(fn, into=name != "ref")
                print(f"phase 22b spec {name} {W}x{H} at {tag}: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 22b spec {name} at {tag} launched {got}, "
                                       f"expected {spec_i8}")
        for kind in stills:
            ok = same(out["ref"], out[kind])
            print(f"phase 22b at {tag}: spectrum from the {kind.upper()} == from the PNG: "
                  f"{ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 22b at {tag}: the {kind} route differs from PNG's")
        back = {}
        with _policy("i8@1e-5"):
            for ext in ("ppm",) + OTHER_ISPEC:
                back[ext] = os.path.join(tmp, f"back.{ext}")
                fn = lambda o=back[ext]: _run_tool(  # noqa: E731
                    torch, ispec, list(device_args)
                    + ["-t", "flat", "-G", "1000", out["qoi"], o], int8mm)
                (wall, stages, got), _ = count.run(fn)
                print(f"phase 22b ispec to {ext} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 22b ispec to {ext} launched {got}")
        with open(back["ppm"], "rb") as f:
            arr = imgcodecs.decode_pnm(f.read())[0]
        for ext in OTHER_ISPEC:
            name = images._format_name(None, back[ext])
            enc = images._NAMED_WRITERS.get(name)
            want = enc(arr, back[ext]) if enc else images._NATIVE_WRITERS[name](arr)
            with open(back[ext], "rb") as f:
                ok = f.read() == want
            print(f"phase 22b ispec {ext} == the port's encoder of the PPM's pixels: {ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"phase 22b: ispec's {ext} is not its encoder's bytes")
        for ext in OTHER_EXTS:      # write_image's encoders on its levels of ``pix``
            path = os.path.join(tmp, f"still.{ext}")
            name = images._format_name(None, path)
            enc = images._NAMED_WRITERS.get(name)
            t0 = time.perf_counter()
            data = enc(lv, path) if enc else images._NATIVE_WRITERS[name](lv)
            enc_s = time.perf_counter() - t0
            ok = sha(data) == OTHER_4K_DIGESTS[ext]
            print(f"phase 22b encode {ext} {W}x{H}: {len(data)} bytes in {enc_s:.4f} s "
                  f"({H * W * 3 / 1e6 / enc_s:.1f} MB/s of RGB); == Pillow's digest: {ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"phase 22b: the 4K {ext} write is not Pillow's: {sha(data)}")

        # ---- (c) motion's lowpass on RLE TGA frames against a PPM sequence --------
        strip = fx.levels((MH, MW + 4 * frames), OTHER_4K_SEED + 1, noise=0.02)
        dec_s = 0.0
        for k in range(frames):
            data = fx.make_tga(np.ascontiguousarray(strip[:, 4 * k:4 * k + MW, ::-1]), 10, 24)
            with open(os.path.join(tmp, f"in{k:04d}.tga"), "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            dec = rawimg.decode_tga(data)[0]
            dec_s += time.perf_counter() - t0
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(dec))
        mh, mw = dec.shape[:2]
        print(f"phase 22c {frames} RLE TGA frames {mw}x{mh}: decode {dec_s:.3f} s "
              f"({frames * mh * mw * 3 / 1e6 / dec_s:.1f} MB/s of RGB)", flush=True)
        runs = {}
        for kind in ("ppm", "tga"):
            target = os.path.join(tmp, f"o_{kind}.y4m")
            t0 = time.perf_counter()

            def run(kind=kind, target=target):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{kind}"), target])
                if rc != 0:
                    raise RuntimeError(f"phase 22c motion {kind} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, got = count.run(run, into=kind == "tga")
            runs[kind] = got
            print(f"phase 22c motion {kind} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches {json.dumps(got)}",
                  flush=True)
        ok = same(os.path.join(tmp, "o_tga.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 22c TGA sequence == PPM sequence to y4m: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 22c: the TGA sequence's y4m differs from the PPM's")
        if runs["tga"] != runs["ppm"] or not runs["tga"].get("right3"):
            raise RuntimeError(f"phase 22c: launches {runs['tga']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"other {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 22 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 23: Zstandard and LZMA TIFF, and libtiff's old LSB-first LZW (io/imgcodecs.py,
# native/zstd.cpp, the standard library's lzma, native/tiff.cpp) ------------------
# (a): sha256 of each file of tests/goldens/ (tests/torch_codec_fixtures.py's
# ZSTD_LZMA_PILLOW, ZSTD_LZMA_MADE and STRIP_DONORS) and of the JAX package's
# read_image(..., "RGBA") float64 pixels of it
ZSTD_LZMA_FIXTURES = {
    "zstd_l.tif": ("4e2f523a73883f6162b3128d765e5553870702d3bc0d3b6c6790a6142c72a7c6",
                   "b79fb33dc0fc56f346024b67e5d481d0648cf3072c3925f6815b160f1ad879f9"),
    "zstd_rgb_p2.tif": ("fd8b6b8785a0e6d3efaf395dbcb17a39ec5a4cbcdb69e383f3d6f1aecdb7cba2",
                        "d0a6abe82436af2984e26998994c9c28e2c83ff183cd622174855176a1fdd02d"),
    "zstd_rgba.tif": ("038ad9128326ef464d420cc60d6550e88e09b07e8e51cf703fb622e856b1c640",
                      "e34ff9f1ee77255a20e985d6b802f025f3209c050dd1ae25f00ede8e36d5fd2b"),
    "zstd_i16_p2.tif": ("abd5f2b681b0e617a44b48d3f7d1b2c55e75e8a0524f4a724ced3b0a0093fe44",
                        "69496c8f1250916a7c1d64c4f5bd942f2311d60154715d2636c4818d6f5579d1"),
    "zstd_f_p3.tif": ("7176b2c468c3cd75eadf2f47b39569d9f67c2225af6362f6fd207fcc32b1ad00",
                      "1b17c81e17b3b74a8c43fa9474f119e82dda0c661801d04051b2d0b88dc5f684"),
    "lzma_l.tif": ("44dcd560b02d75b96c542a7450958bd319f870f8cccaf65e9dcda2b4af0273bc",
                   "b79fb33dc0fc56f346024b67e5d481d0648cf3072c3925f6815b160f1ad879f9"),
    "lzma_rgb_p2.tif": ("4576b7175bfa951bac57bda754c38effdee3d89ae6e559b19ac0cf3345e70e14",
                        "d0a6abe82436af2984e26998994c9c28e2c83ff183cd622174855176a1fdd02d"),
    "lzma_rgba.tif": ("489bafdf283b3506faea1206563d686a052c582628d35b4e28eec17c5ed61c14",
                      "e34ff9f1ee77255a20e985d6b802f025f3209c050dd1ae25f00ede8e36d5fd2b"),
    "lzma_i16_p2.tif": ("7878a5653979c1b29a9574a92d42e6887e3bca72782238f2c0a517818d886e7b",
                        "69496c8f1250916a7c1d64c4f5bd942f2311d60154715d2636c4818d6f5579d1"),
    "lzma_f_p3.tif": ("fc816304355e294e1f126f1c44ada84f99c894a22a7d6af6536b55032a441fb5",
                      "1b17c81e17b3b74a8c43fa9474f119e82dda0c661801d04051b2d0b88dc5f684"),
    "zstd_tiled_p2.tif": ("e331932a7eb7c2e7c339b1cdb07b87f6a49e21cfd113ab03e8180a608174f86a",
                          "dc4e3fd1a79ed43a70c73d99bdd86fee29ba8c368a41a5f4e4e365929f6ce338"),
    "zstd_planar_p2.tif": ("6c78ecc9957d1bc71bf55b423acaeaca52927a754063b840e8be4c04a2c2b67f",
                           "7c6aeef4f3d60666bad6052acb539520dd2e1f099137669ce86a5ccb29cc5e5b"),
    "lzma_tiled_p2.tif": ("20519d9fc6a46e13f7cf9afab86b07de2680315c1d6826b1b780e5fabecb167e",
                          "dc4e3fd1a79ed43a70c73d99bdd86fee29ba8c368a41a5f4e4e365929f6ce338"),
    "lzma_planar_p2.tif": ("6539a7993123aea97f49cb45438ffe272d17a1af8440af1a7efd805db42164e2",
                           "7c6aeef4f3d60666bad6052acb539520dd2e1f099137669ce86a5ccb29cc5e5b"),
    "zstd_4k_strips.tif": ("7b9c39d364493223603c43af7780184997b7f3624de956fe320192a4c4138679",
                           "afbef5924440951f6b1206dca05b0c40e3fbcf6fd0f43355e8c234aa78fb3876"),
    "lzma_4k_strips.tif": ("94d2745616c91ccf22b80660631bc006ba35e26f3be59b6d0fb07afeb5b3c249",
                           "afbef5924440951f6b1206dca05b0c40e3fbcf6fd0f43355e8c234aa78fb3876"),
}
# (a): the same of the fixtures module's old_lzw_tiffs(), written at run time
OLD_LZW_DIGESTS = {
    "old LZW L": ("dfeba115b507a7d1f3fc3045d041ed825920b3d2ea8d1d7d3231995bd0b37be3",
                  "d2ab5f4711634dc05287eeb0160193f0cf74cb82e424cd54fb99d97700912689"),
    "old LZW RGB predictor 2": (
        "2de7e8743b10a8fff2f7f848305a24ff6ed922a323a7dfd941cca1d000371ae0",
        "bcfe00c05b8ba638639e131fa4ea1bc9df8a4baa07ab62e5647b79f8b53fcf4a"),
    "old LZW tiled RGBA": ("ea8c213bc01d642aa5d8624642fe4907d263aca0e2d9b9aa24e41fbe32dd27b7",
                           "bf93e7406dd56feb89d5b0035184e95303d471bf0f5ce63906a0bbc4771f67ee"),
    "old LZW planar RGB;16 big-endian": (
        "fff9b1c6d1b5f8d31891dd18cccc4d4aeb814946b640c671ce751d56f7e92f91",
        "33a040a086060477cc7fac8fe6085c711d463c5b137b7d2874c93bdeabd2ff92"),
    "old LZW FillOrder 2 L": ("0ab0c5654d1d3e237f5dce967c91b0d6d50214610470e4b29ec1d0fff67adaef",
                              "d2ab5f4711634dc05287eeb0160193f0cf74cb82e424cd54fb99d97700912689"),
}
# (b): sha256 of Pillow's uint8 RGB decode of the 3840x2160 files that
# strip_4k makes of either donor (both hold the same levels)
STRIP_4K_DIGEST = "469384418e5de133b9e588d630a428dcd791be2b8a4e7cec937a83e1aa5328c1"
ZSTD_LZMA_REPEATS = 3             # (b): the 4K decodes, best of
ZSTD_LZMA_FRAMES = 8              # (c): motion's lowpass on 8 1080p LZMA and Zstandard frames


def _zstd_lzma_phase(torch, dev, int8mm, block_filter, check_i8mm, fft,
                     frames=ZSTD_LZMA_FRAMES, motion_hw=(MH, MW), device_args=()) -> dict:
    """Main path 19: Zstandard and LZMA TIFF, and libtiff's old LSB-first
    LZW, through the port's own codecs (``io/imgcodecs.py`` on
    ``native/zstd.cpp``, the standard library's lzma and
    ``native/tiff.cpp``).  (a) The fixtures of tests/goldens/ and the
    old-LZW files the fixtures module writes, each through
    ``images._decoder`` to ``decode_tiff`` and read to the JAX package's
    digests; (b) the 3840x2160 Zstandard and LZMA files ``strip_4k``
    assembles of the donors' strips decoded (best of
    ``ZSTD_LZMA_REPEATS``) to Pillow's digest, spec of the Zstandard file
    at ``i8@1e-5`` against the same levels as a PNG; (c) motion's lowpass on 1080p frames written
    as LZMA (even frames, liblzma's preset 0) and Zstandard (odd ones,
    the fixtures module's raw blocks) TIFF to y4m against a PPM sequence
    of their decoded frames.  Returns the kernels' launches over the
    runs of the new formats."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs
    from dspfun_tpu_torch.tools import motion, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    imgcodecs._zstd_lib()
    imgcodecs._tiff_lib()
    print(f"phase 23 native/zstd.cpp and native/tiff.cpp load: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zstd_") as tmp:
        # ---- (a) the fixtures to the JAX package's digests -------------------------
        files = {name: os.path.join(gold, name) for name in ZSTD_LZMA_FIXTURES}
        for name, data in fx.old_lzw_tiffs().items():
            files[name] = os.path.join(tmp, name.replace(" ", "_").replace(";", "") + ".tif")
            with open(files[name], "wb") as f:
                f.write(data)
        for name, path in files.items():
            with open(path, "rb") as f:
                data = f.read()
            if images._decoder(data) is not imgcodecs.decode_tiff:
                raise RuntimeError(f"phase 23a: {name} does not take the port's TIFF decoder")
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            got = (sha(data), fx.rgba_digest(img.pixels))
            want = ZSTD_LZMA_FIXTURES.get(name) or OLD_LZW_DIGESTS[name]
            print(f"phase 23a {name} {img.width}x{img.height} depth {img.depth}: {len(data)} "
                  f"bytes; read {dec_s:.4f} s; file and pixels == the JAX package's digests: "
                  f"{got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 23a: {name} is not read as the JAX package reads it: "
                                   f"{got}")

        # ---- (b) the 4K files: decode, spec and ispec ----------------------------
        src = {}
        for name, kind in fx.STRIP_DONORS.items():
            with open(files[name], "rb") as f:
                data = fx.strip_4k(f.read(), H)
            src[kind] = os.path.join(tmp, f"still_{kind}.tif")
            with open(src[kind], "wb") as f:
                f.write(data)
            best = float("inf")
            for _ in range(ZSTD_LZMA_REPEATS):
                t0 = time.perf_counter()
                arr, _ = imgcodecs.decode_tiff(data)
                best = min(best, time.perf_counter() - t0)
            ok = sha(arr.tobytes()) == STRIP_4K_DIGEST
            print(f"phase 23b {kind} TIFF {arr.shape[1]}x{arr.shape[0]} (predictor 2, "
                  f"{len(data)} bytes): decode {best:.4f} s (best of {ZSTD_LZMA_REPEATS}; "
                  f"{arr.size / 1e6 / best:.1f} MB/s of RGB, {len(data) / 1e6 / best:.2f} MB/s of "
                  f"file); pixels == Pillow's digest: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 23b: the 4K {kind} TIFF decodes to other pixels")
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, arr / 255.0)
        sh, sw = arr.shape[:2]
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        out = {k: os.path.join(tmp, f"spec_{k}.png") for k in ("ref", "zstd")}
        with _policy("i8@1e-5"):
            for name, inp in (("ref", ref), ("zstd", src["zstd"])):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "zstd")
                print(f"phase 23b spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 23b spec {name} launched {got}, expected {spec_i8}")
            ok = same(out["ref"], out["zstd"])
            print(f"phase 23b spectrum from the Zstandard TIFF == from the PNG: {ok}", flush=True)
            if not ok:
                raise RuntimeError("phase 23b: the Zstandard route differs from the PNG's")

        # ---- (c) motion's lowpass on LZMA and Zstandard frames against PPM --------
        mh, mw = motion_hw
        strip = fx.levels((mh, mw + 4 * frames), fx.STRIP_SEED + 1, noise=0.02)
        enc_s = dec_s = 0.0
        for k in range(frames):
            frame = np.ascontiguousarray(strip[:, 4 * k:4 * k + mw])
            t0 = time.perf_counter()
            if k % 2:
                data = fx.make_tiff(frame, "RGB", compression=50000, predictor=2,
                                    rows_per_strip=64, codec=fx.zstd_stored)
            else:
                data = fx.make_tiff(frame, "RGB", compression=34925, predictor=2,
                                    rows_per_strip=64, level=0)
            enc_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            dec = imgcodecs.decode_tiff(data)[0]
            dec_s += time.perf_counter() - t0
            if not np.array_equal(dec, frame):
                raise RuntimeError(f"phase 23c: TIFF frame {k} decodes to other levels")
            with open(os.path.join(tmp, f"in{k:04d}.tif"), "wb") as f:
                f.write(data)
            with open(os.path.join(tmp, f"in{k:04d}.ppm"), "wb") as f:
                f.write(imgcodecs.encode_pnm(dec))
        print(f"phase 23c {frames} frames {mw}x{mh}: LZMA and Zstandard TIFF write {enc_s:.3f} s, "
              f"decode {dec_s:.3f} s ({frames * mh * mw * 3 / 1e6 / dec_s:.1f} MB/s of RGB)",
              flush=True)
        runs = {}
        for kind in ("ppm", "tif"):
            t0 = time.perf_counter()

            def run(kind=kind):
                rc = motion.main(MOTION_ARGS + list(device_args)
                                 + [os.path.join(tmp, f"in%04d.{kind}"),
                                    os.path.join(tmp, f"o_{kind}.y4m")])
                if rc != 0:
                    raise RuntimeError(f"phase 23c motion {kind} -> y4m exited {rc}")
                return dict(motion.LAST_STAGE_TIMES)

            stages, runs[kind] = count.run(run, into=kind == "tif")
            print(f"phase 23c motion {kind} -> y4m: {time.perf_counter() - t0:.3f} s; stages "
                  f"{_stages(stages)} (read decodes the frames); launches "
                  f"{json.dumps(runs[kind])}", flush=True)
        ok = same(os.path.join(tmp, "o_tif.y4m"), os.path.join(tmp, "o_ppm.y4m"))
        print(f"phase 23c LZMA and Zstandard TIFF sequence == PPM sequence to y4m: {ok}",
              flush=True)
        if not ok:
            raise RuntimeError("phase 23c: the TIFF sequence's y4m differs from the PPM's")
        if runs["tif"] != runs["ppm"] or not runs["tif"].get("right3"):
            raise RuntimeError(f"phase 23c: launches {runs['tif']} (PPM route {runs['ppm']}); "
                               "kernel #2 never launched")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"zstd_lzma {layout}{nd} {m}x{k}")
        if count.total.get("block_filter"):
            _check_block_filter(torch, dev, block_filter, fft, shapes=count.bf_checks())
    wall = time.perf_counter() - t_phase
    print(f"phase 23 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 24: progressive JPEG left short, smoothed, and 8-bit lossless JPEG
# (io/jpeg.py, native/jpeg.cpp) ----------------------------------------------------
# (a) and (b): sha256 of each file tests/torch_codec_fixtures.py makes at run
# time (short_jpegs(): cut from Pillow's goldens; lossless_jpegs(): its own
# writer) and of Pillow's convert("RGB") of it (tests/test_torch_jpeg_lossless.py
# pins them to Pillow)
SHORT_JPEG_DIGESTS = {
    "prog4k_dc.jpg": ("38d1a19d53cb4f080c06a067393577538ce41dc6deefbbf86ba2fc8cba5e9f11",
                      "d13ce96518455d1109e7166f82d06f711be0ee11d6bcf8cf009d2111b9a7f6e5"),
    "prog4k_short.jpg": ("48742d4f07f0b81847595ee6c323824e1796e553ea622a95f39002742826b1a4",
                         "f5071ca3999094727e8414361e9c1420d3d3c0ef055eb09fd353aa4df8dce289"),
    "gray_short.jpg": ("c28b23af08a767789cb90addfce61d2fb551b3d0edf32cded003cf7994a5bceb",
                       "f796c6e78144f9e545ba6f4a802960d861d8f6abb95112976f6307621ca4b9e2"),
    "rst444_dc_al1.jpg": ("6eaab59ce59033b8c159d8cf004202f7b542a9fb0a7ce3060b8b63c4ac71ce2a",
                          "2825bd3c7d5e94597870a5d823d3d6d6230610170914435c953b1288a42915fd"),
    "rst444_unrefined.jpg": ("35bd583fe709fe464403940207b70f19e33ce69af83880810289546d5026fc69",
                             "ead649316996cef06896c028252ed554fd9601ae6fd0777addea7f6973753285"),
}
LOSSLESS_DIGESTS = {
    "ll_gray_p1.jpg": ("cb83303db76eadea8eb4fc0c1e38c1d93b808fb500618db0e586074a6ac10c10",
                       "39031b6c510087a19bffe69fe2073597dae540d18cd0f94347f444a8f6dc707e"),
    "ll_gray_p2_pt2.jpg": ("24cd8fa9e5dc8b3c3aa4b6b2bd3a7f51d58cbb0230a85cbba7adfd23f3e031c0",
                           "0802d943054c454b2f019ba2ba87ce4e1fdf67791287f90b4059c5d29708c94f"),
    "ll_rgb_p3.jpg": ("9e284ec938958dc100c7aaea5360a1ea13d5a1dff39c8f8618900743ed319e37",
                      "b65fec3e22df69ca40ffdf9749d827c4ed2d479374360aca4c14795e8dc44c6d"),
    "ll_rgb_p4_pt1_rst.jpg": ("c38dc8e96fddb8665ba861cf9858143d61e4729a597b793a29d217c7f7bec0c1",
                              "0f715d25436d3329118d58ca5b640b44814c2b28354cbfabc68ce450c7a0e666"),
    "ll_rgb_p5_scans.jpg": ("21a28d6e8e3648b2e77654f1677f0364b54e3beb1865721b26ab59a5f01ca89a",
                            "1682a39efa4ce59d14b19766d25665540c0e119a448931287c520563395a9787"),
    "ll_rgb_p6_420.jpg": ("25658e706e7126390d8ec0b1035a54a09149645de3ee0d909a10f9262f098ca2",
                          "3d61e087c8b3f13b741c187abc91c1dc7eb50619442c9f7d703ee6072d9b602d"),
    "ll_cmyk_p7_rst.jpg": ("279073f56a2f853ffb12ee0e855678d721214fc2ae95008eb1bcec2aef6acc9d",
                           "33145a9afa68708f9bc828d9d0919c680c214d5fad86df9f37c5520abf2a4a7a"),
}
SHORT_4K = ("prog4k_dc.jpg", "prog4k_short.jpg")   # (b): decoded best of SHORT_REPEATS
SHORT_SPEC = "prog4k_short.jpg"                    # (b): the file spec and ispec run on
SHORT_REPEATS = 2
LOSSLESS_4K = dict(predictor=1, restart=W * 16)    # (c): CODEC_4K's levels, 135 intervals


def _short_lossless_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, big=CODEC_4K,
                          spec_file=SHORT_SPEC, lossless_kw=None, device_args=()) -> dict:
    """Main path 20: progressive JPEG left short, smoothed as libjpeg-turbo
    smooths it, and 8-bit lossless JPEG, through the port's own codec
    (``io/jpeg.py`` on ``native/jpeg.cpp``).  (a) The short progressive
    files the fixtures module cuts from Pillow's goldens and its
    hand-made lossless files, each through ``images._decoder`` to
    ``decode_jpeg``, file and pixels equal to Pillow's digests; (b) the
    two 3840x2160 short files decoded (best of ``SHORT_REPEATS``) to
    Pillow's digests, spec of ``spec_file`` at ``i8@1e-5`` against the
    same pixels as a PNG; (c) a
    3840x2160 lossless JPEG of ``big``'s levels written by the fixtures
    module and decoded to those levels exactly.  Returns the kernels'
    launches over the runs of the new formats."""
    import hashlib

    from dspfun_tpu_torch.io import images, jpeg
    from dspfun_tpu_torch.tools import spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg._load()
    print(f"phase 24 native/jpeg.cpp load: {time.perf_counter() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_short_") as tmp:
        # ---- (a) the fixtures to Pillow's digests ---------------------------------
        t0 = time.perf_counter()
        made = {**fx.short_jpegs(), **fx.lossless_jpegs()}
        print(f"phase 24a {len(made)} files cut and written: {time.perf_counter() - t0:.3f} s",
              flush=True)
        decoded = {}
        for name, data in made.items():
            if images._decoder(data) is not jpeg.decode_jpeg:
                raise RuntimeError(f"phase 24a: {name} does not take the port's JPEG decoder")
            frame = jpeg.decode_coefficients(data)[0]
            kind = "lossless" if frame.lossless else \
                f"smoothed, latch {frame.latch[:10]}" if frame.smoothed else "not smoothed"
            if not (frame.lossless or frame.smoothed):
                raise RuntimeError(f"phase 24a: {name} is neither lossless nor smoothed")
            best = float("inf")
            for _ in range(SHORT_REPEATS if name in SHORT_4K else 1):
                t0 = time.perf_counter()
                arr, depth = jpeg.decode_jpeg(data)
                best = min(best, time.perf_counter() - t0)
            decoded[name] = arr
            got = (sha(data), fx.rgb_digest(arr))
            want = SHORT_JPEG_DIGESTS.get(name) or LOSSLESS_DIGESTS[name]
            reps = f" (best of {SHORT_REPEATS})" if name in SHORT_4K else ""
            print(f"phase 24{'b' if name in SHORT_4K else 'a'} {name} {arr.shape[1]}x"
                  f"{arr.shape[0]}x{arr.shape[2]} ({kind}; {len(data)} bytes): decode "
                  f"{best:.4f} s{reps}, {arr.size / 1e6 / best:.1f} MB/s of samples; file and "
                  f"pixels == Pillow's digests: {got == want}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 24: {name} is not decoded as Pillow decodes it: {got}")

        # ---- (b) spec and ispec of a short file ----------------------------------
        src = os.path.join(tmp, spec_file)
        with open(src, "wb") as f:
            f.write(made[spec_file])
        arr = decoded[spec_file]
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, arr / 255.0)
        sh, sw = arr.shape[:2]
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        out = {k: os.path.join(tmp, f"spec_{k}.png") for k in ("ref", "jpg")}
        with _policy("i8@1e-5"):
            for name, inp in (("ref", ref), ("jpg", src)):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "jpg")
                print(f"phase 24b spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 24b spec {name} launched {got}, expected {spec_i8}")
            ok = same(out["ref"], out["jpg"])
            print(f"phase 24b spectrum from {spec_file} == from the PNG: {ok}", flush=True)
            if not ok:
                raise RuntimeError("phase 24b: the short JPEG's spectrum differs from the PNG's")

    # ---- (c) a 3840x2160 lossless JPEG to its levels ------------------------------
    hw, seed, noise = big
    kw = dict(LOSSLESS_4K if lossless_kw is None else lossless_kw)
    levels = fx.levels(hw, seed, noise=noise)
    t0 = time.perf_counter()
    data = fx.make_lossless_jpeg(levels, **kw)
    enc_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(SHORT_REPEATS):
        t0 = time.perf_counter()
        arr, _ = jpeg.decode_jpeg(data)
        best = min(best, time.perf_counter() - t0)
    ok = np.array_equal(arr, levels)
    print(f"phase 24c lossless JPEG {hw[1]}x{hw[0]} RGB ({json.dumps(kw)}; {len(data)} bytes): "
          f"write {enc_s:.3f} s (tests/torch_codec_fixtures.py, numpy); decode {best:.4f} s (best "
          f"of {SHORT_REPEATS}), {arr.size / 1e6 / best:.1f} MB/s of RGB, "
          f"{len(data) / 1e6 / best:.2f} MB/s of file; == its levels: {ok}", flush=True)
    if not ok:
        raise RuntimeError("phase 24c: the lossless JPEG decodes to other levels")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"short_jpeg {layout}{nd} {m}x{k}")
    wall = time.perf_counter() - t_phase
    print(f"phase 24 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 25: PSD and DDS read, DDS written, CUR, DCX and IM's float and YCbCr
# modes (io/psd.py, io/dds.py, native/bcn.cpp, io/ico.py, io/rawimg.py) -------
# (a): sha256 of each fixture of tests/torch_codec_fixtures.py:psd_dds_fixtures()
# (Pillow's DDS and DCX files from tests/goldens/, the rest written there at run
# time) and of the JAX package's read_image(..., "RGBA") float64 pixels of it
# (tests/test_torch_dds.py pins them)
PSD_DDS_FIXTURES = {
    "cur_1bit.cur":
        ("e2f69b64dd2e763f62ac94986b0a81fa6b9e7b7f6fe82f341f5e6f8a972d9d8c",
         "8044b4c5fde332a901a782c4a076c6704dc6bd94932008a4d7e991f0f23fc5b0"),
    "cur_24bit.cur":
        ("d0d1c1234c696940830b3bfab3202e6edd74ef20c0925952ab76bc1a6570520c",
         "a4159eeec9896fe36504c28e10dc6da9921c7e162641d145965d76d2e62171aa"),
    "cur_32bit.cur":
        ("a33c2cdd3137f46bee3bf18e89ca6602d8a281a9fe042bee7fd6be0fb21b0b1e",
         "ecade696c34b240f730adf38b6aaf8c910226cae776f667c62f705bd1e18ccd7"),
    "cur_4bit.cur":
        ("1ca8e146b45bbd6d4f038bca0622ace34404249b8985824b5a112f54704db7de",
         "2840e12aaa409410b3ba121be7711332d49a8e4153f5edd363255e6bb8779125"),
    "cur_8bit.cur":
        ("7b2164787635dc400b824898d831066454bacd7b9d552463a3eb4f205af2ff12",
         "8abd9f7074e1c9e5cd799ec708ccd41f11170aab5fc2b644047e08d1c9a03ba0"),
    "cur_entries.cur":
        ("e29c4a8819c2da4d69a32c253246bad1d0c4960945b1b988485846e04915417b",
         "a4159eeec9896fe36504c28e10dc6da9921c7e162641d145965d76d2e62171aa"),
    "dcx_p.dcx":
        ("f2abe1145e99986a23dc33ffbc42219bc13f46b1184584022fd66ceb1d97261e",
         "848907805bb3ad3b8240512328e7bc02b1af3aa1c15663c1d6d450d82faac430"),
    "dcx_rgb_l.dcx":
        ("84d2b3e5ff950cb853aa8edba81a841bc1f847de5dffc4181757710c1bfab71c",
         "4eaa6e8d4cbaa794a7dcee878aaf61c403342de87e71c0e215f0e9c24fb96cc1"),
    "dds_a2b10g10r10.dds":
        ("705011445aa9c6bf310153748a41613d36248baf0de76093ab22f0fb2ec366b5",
         "817936bbbd6e4241a315177dbca6759e6a80e310664c40099eaf69abce077956"),
    "dds_argb4444.dds":
        ("f1137e9c951abadf19a185ec46da2cfdb1d7335d45c9191bcbfedb06a3d44b71",
         "5b26635fa6829fb60f9980dc7fff3eeacd5b9e46812bbd02803936653bd3d37c"),
    "dds_ati1.dds":
        ("a8b1eac7690c05b4844345f6cd1374a2439d3a6542b75c6e4b0ed61779002c3b",
         "76935a72daa931d44994dceb1216bec214b15a304bdbd6666e001d1e7b268ba8"),
    "dds_ati2.dds":
        ("1578ce72dfb0834fb185ac8d597aa441a14a1dff166ba6f31deb8841eb8b2cb8",
         "fd96c75615e16412fe857bea4abd51cefdad451c60fda4bcd1613871aa00339f"),
    "dds_bc2.dds":
        ("4bcaff6d6f620d04b1df5602af1e97860c2c7cc2b05493725d81926c760bdcb8",
         "493c91035c10bc3ef9f7bf8065647539cd77ca37952ea0ba11e792f6e48c8dd0"),
    "dds_bc3.dds":
        ("0e7427b438238a2549934383b90104fc148fdb5853919a6f11d0bcbc10124131",
         "c3996e2709b62714f598917c4f45d9805d21acdc5c90b238e8fb2db379e8641d"),
    "dds_bc4.dds":
        ("bfcd2c945ccfe064977f4e90ef9bdf222567bcf84d44fb96277b0eb55909f1a5",
         "7d1ae0c51e3712022a53fee9921b35bac8b710f25a38b722bf407ad819c6a232"),
    "dds_bc5.dds":
        ("f7cb5a009c55c5077d8139cdf51a42dc23404547805db77430cafa77a52f925e",
         "cc00685ac072c8bff31a4f04f9696dfe785853a320a2d0fb96c843e68c738097"),
    "dds_bc5s.dds":
        ("08d0404f5d55591eb98e93355b7166605222926eebbd29b54ac1c3b86ba0bdb6",
         "3bf3fe93f0bdfcc4855d4ceab7e4ebef796728f281ea58103f6ef7214155e73a"),
    "dds_bc6h_sf16.dds":
        ("08ff749cc12c2c47fee707ac27cbf5fb3e952c0577758b5bb1e264cab09f2dd4",
         "7a5bc594ff5db05e642049240b8eb289aecd9c4e5f55304e0602ead0e9075de7"),
    "dds_bc6h_uf16.dds":
        ("00a5765a2323815eac3b3187a71c6c51021d7d0eaba22b0855f1d3bb1e35f5f7",
         "5caa83b4b61c5150b78ce24ad93504c7c950c0d969ff5d208739deaf57e8d208"),
    "dds_bc7.dds":
        ("e708d7c89657ba48de0a0e8b939a35a9682716031f450e5699f6573c1495b363",
         "8333da3c1cfe0c62f412297079d75335c1b19e54a5fdd7ed0b64adee4fefe957"),
    "dds_bc7_srgb.dds":
        ("4803d7f33a9175f93b4526075e12cbd297cf911d54eb409cbc0bddc37f32ed5d",
         "6c87d9a77ed98eef723cfbab1d5a2dc8f0c3149f4b180b9e3a8002ac0d06cb5b"),
    "dds_dx10_bc1.dds":
        ("18a759dc4fb39d00ae6300862e2d50d815fe1add0cfca35e2de975c08f86f950",
         "6b4dc8693db1e995b03ffba6452dedce41800dbc56564590cbdb5aba2d1cbddd"),
    "dds_dx10_rgba8.dds":
        ("ed413fcb15302f0e16e6713cb79e312e0944001e6b4d2c24c90c4f31f476dcc3",
         "09edb5d9ba55b1d9b932b1c7235f80ec95ff49cc05ffbec173a5c5239b1432d4"),
    "dds_dxt1.dds":
        ("b806ca8594a32f57f9b1a6f940ad4dfb277c836cf0c8a0c84901d160464981e3",
         "82339900f16c7d8df61300027e99e07c527d22cf3659913ab44177fa40d5f2d0"),
    "dds_dxt3.dds":
        ("0feed8b7c908dafc914bc8c6c8cb977b1b50538fb6c0f00b1350148a01073c65",
         "493c91035c10bc3ef9f7bf8065647539cd77ca37952ea0ba11e792f6e48c8dd0"),
    "dds_dxt5.dds":
        ("a1b9ec703c0b122c7e1d6430161049af2bf573177247c409b3e62170ef2bb589",
         "c3996e2709b62714f598917c4f45d9805d21acdc5c90b238e8fb2db379e8641d"),
    "dds_l.dds":
        ("2a1c577c0f4b59cb5c879c1a33272e0adcae6f27963368a1c3ff997e2284ec6c",
         "a3692b42e415b4c2bf3901a95eb78d620aa76f1e17d35fcd0b59ae12ca6b85bd"),
    "dds_la.dds":
        ("72fb943af8753fdfd7a30075d12e705e83c50bc4e38737889153b834bf97e038",
         "9992f1d4e404c3716466e5f85f94610bf2fef407ec0a5c9b0346c4c42ee9538a"),
    "dds_palette.dds":
        ("71271ca54f03ae67f462d265b9f5c59ba8513cba506b24a9753a1e0d782ac2a2",
         "7f7b16e8ba1c3a1c9068946a928cc7f9a983e7ff5bcf35e173f78a336671200b"),
    "dds_rgb.dds":
        ("00a846f487b5f8180359035aa0c83f7f073ec87d190a807455ef1c4f1a8c15d1",
         "4eaa6e8d4cbaa794a7dcee878aaf61c403342de87e71c0e215f0e9c24fb96cc1"),
    "dds_rgb24_bgr.dds":
        ("f0b63e9f7ba2fbda5cac9ab00dd3a61be5d79d4b2c775914680956501aee7ffe",
         "e54efec4a59c801d0a027148234fbe5529f1cceaa3a087990dfdd5562a356c5c"),
    "dds_rgb565.dds":
        ("3bcb07e894b92d14fe844de697551c2a0dbbd0deb1a0314ca52e74a79427e7d6",
         "6dc10bde993bd9377f21d206b2d91983d9a279d3bcb706443daa80d160ad5c5b"),
    "dds_rgba.dds":
        ("6a16839fa2f1626c5530a4fb5b1ca948a6dfa97bf4f2dcbb8bb5df2ab5876a1d",
         "e1b0fdc73582d1f08bde6c3281b1591309f510085514e902669cfa1f0fa388ce"),
    "im_bits12.im":
        ("d6b1631a0cef6943f4fa85fb942772ba915c40affe6c56ccf9da472393ff922a",
         "899f3daf5d0d38411c32b605987370568a4b65fb82def751e13e97a24cb42636"),
    "im_bits5.im":
        ("60b0a7eada49bac57c9eb5ed0dfd606a332414af94c34d229a740d9475518d55",
         "8a5a62e648582cf142a79bde70e89bd6a8fa1c51013db96a31ff400c9004e7ce"),
    "im_f16s.im":
        ("c00df471a6350899e0317fa4f4aec46731081e5899e8c65a3d333e53ffc7ee97",
         "71a01d8d0de71aea3bfb36fb0a8ebdfdb7717256d601b7885b7147a4ab02db96"),
    "im_f32.im":
        ("454f60b5087c85e72a38192e9f274ad73050b98979098ccf490d670351e282c0",
         "f5a3fe47bb1308337afbdd344682de27a3c0c99dfecb3ed365c038e099f46c55"),
    "im_f32u.im":
        ("bf6dc001dcf44abf4ade5a819c61c8478250ea0eb607452e81d2950455c22d06",
         "ec4ca634c45fc914799660dd947b48cf6b27bdb2e7cc95a94a08c50e8df52502"),
    "im_f8s.im":
        ("77615581f6aa3fd99e98a936cea6a1b58529424274c0544686135526aba72932",
         "cc06e2b7af50e0e3ab753effe1ebc274e07771ac60d3a843be6bbf36d310b59f"),
    "im_ycc.im":
        ("ac63e007e9a9bb7f0546f8c8621cbff7010549b72aa530bf313476a9c0cd2b59",
         "e7b786b1e2b3eac2f554661fa67ef159efb7344f8d49dc6fd131dd08097acedb"),
    "psd_bitmap_packbits.psd":
        ("c0f8af97581f8807138fc33e3bb0339c70c0a57bcccf678c1863086a0b893946",
         "8ec345ccefd321fa5e057d0db4c15d4dd193c423b838dba157e792bf0ca926ef"),
    "psd_cmyk_packbits.psd":
        ("596bbbbcc13f7f47f1f6c98f4b249829e222d49f11e94c92ffa75d20137ca2d7",
         "8d2bba32e75d5ad5488aaa42118d6149ecdac693ac51c775d81f066627ffb5de"),
    "psd_duotone_raw.psd":
        ("3b7ece2294df267bb90dfa3c0fc45c4e738b464fad6719f2320eee4ec387d28a",
         "e0ad83d15b0167258202a37d3a5a073db02f9de97a73fbb0c994e4e11556a9cb"),
    "psd_gray_packbits.psd":
        ("dbc648f426a7bc1141cb95085bdfde54617b552fe77ac3c94d72fbe18586ed59",
         "e0ad83d15b0167258202a37d3a5a073db02f9de97a73fbb0c994e4e11556a9cb"),
    "psd_indexed_raw.psd":
        ("21dd17dc19a0781e37e764e6b82b0deb0fe46062c8cc07b1a3d66d541c072995",
         "4f40924a1e8bf7d7a60b6de97ef1c68a7a46cec99bc36397b47d29ddc0297135"),
    "psd_lab_raw.psd":
        ("501975bb20df9f10eeccb6c67a77998eed10ae7d2c79c2609fc7c16771c4f483",
         "eb5edb616e54e92f74eb83d0f48453bd02c923389d17c2a6f9d815a192256b73"),
    "psd_multichannel_packbits.psd":
        ("4307d3fc62b060c4eb921943d2ff1a9b6bb86bb99a88326f8480491457ab4c40",
         "4bc2df48fada54fecf526835f950f0971ca09d7d6b7270166a7e1dff84986bdf"),
    "psd_rgb_extra_raw.psd":
        ("5f1c6b872c268af30d8a4d8937f35ab314bf6a2da5ec1ef25dfc0d8f515fb186",
         "3932fc395066d0b1407e3509c9040f793d4a448688cdd488d3f37d243a439d38"),
    "psd_rgb_packbits.psd":
        ("b5f7df24edf8df1375103878ed35a6c12da7eeb5ea1a56850c5e552f5d1cb534",
         "3932fc395066d0b1407e3509c9040f793d4a448688cdd488d3f37d243a439d38"),
    "psd_rgb_raw.psd":
        ("a6fec4b5a72f2aa5fc053d7a2c03a4a1feb269091ed43d055ca079f54938e225",
         "3932fc395066d0b1407e3509c9040f793d4a448688cdd488d3f37d243a439d38"),
    "psd_rgba_packbits.psd":
        ("7dcb35ac75aa15de3e73bb5327dfb79cf2e9f934a2f2368777ca596dbbd9a9b2",
         "48b4df7ee465c6f955e8fcc3e27ac800fc3b69df8c377b5fd268fd81e02b567d"),
}
PSD_4K_CROP = "891b9c7914c4b23abbdcdc83bde284b37eb2f75c7159c61b9b2a5facc7eb9f11"
DDS_4K = "54ea3ceb35f00c19f86c4e48b9dfd15db66159cad1b904fd4911843f68483c9a"  # Pillow's DDS
BC7_4K_SEED = 61                  # (b): the 4K BC7 file's random blocks
BC7_4K = ("f80088f5359e9018606db025991fb4af45a38c844cfcd33cd1a4d6d07603eef5",   # the file
          "b643c8aaf2a5fb85b16b8ac82b0c31e27212c4fd2c799607ab5f8bed9a9c9ee1")   # Pillow's RGBA
PSD_DDS_REPEATS = 2               # (b): the 4K decodes, best of


def _psd_dds_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, big=CODEC_4K,
                   device_args=()) -> dict:
    """Main path 21: PSD and DDS read, DDS written, CUR, DCX and IM's float
    and YCbCr modes through the port's own codecs (``io/psd.py``,
    ``io/dds.py`` on ``native/bcn.cpp``, ``io/ico.py``, ``io/rawimg.py``).
    (a) Every fixture of ``psd_dds_fixtures()`` through ``images._decoder``
    to its decoder, file and pixels equal to the JAX package's digests;
    (b) a 3840x2160 PackBits RGB PSD of ``big``'s levels (the fixtures
    module's writer) and a DX10 BC7 DDS of seeded random blocks, decoded
    (best of ``PSD_DDS_REPEATS``) to the levels and to Pillow's digest;
    (c) spec of the PSD at ``i8@1e-5`` against the same levels as a PNG;
    (d) ispec at ``i8@1e-5`` to DDS and to PPM, the DDS file equal to
    ``encode_dds`` of the PPM's pixels, and ``encode_dds`` of the levels
    equal to Pillow's digest.  Returns the kernels' launches over the runs
    of the new formats."""
    import hashlib

    from dspfun_tpu_torch.io import dds, ico, images, imgcodecs, psd, rawimg
    from dspfun_tpu_torch.tools import ispec, spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    decoders = {"psd": psd.decode_psd, "dds": dds.decode_dds, "cur": ico.decode_cur,
                "dcx": rawimg.decode_dcx, "im": rawimg.decode_im}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dds._load()
    rawimg._load()
    print(f"phase 25 native/bcn.cpp and native/rawimg.cpp load: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_psd_dds_") as tmp:
        # ---- (a) the fixtures to the JAX package's digests -------------------------
        goldens = {}
        for name in fx.PSD_DDS_GOLDENS:
            with open(os.path.join(gold, name), "rb") as f:
                goldens[name] = f.read()
        made = fx.psd_dds_fixtures(goldens)
        if sorted(made) != sorted(PSD_DDS_FIXTURES):
            raise RuntimeError(f"phase 25a: the fixtures are not {sorted(PSD_DDS_FIXTURES)}")
        for name, data in sorted(made.items()):
            ext = name.rsplit(".", 1)[1]
            if images._decoder(data) is not decoders[ext]:
                raise RuntimeError(f"phase 25a: {name} does not take the port's {ext} decoder")
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            got = (sha(data), fx.rgba_digest(img.pixels))
            print(f"phase 25a {name} {img.width}x{img.height} depth {img.depth}: {len(data)} "
                  f"bytes; read {dec_s:.4f} s; file and pixels == the JAX package's digests: "
                  f"{got == PSD_DDS_FIXTURES[name]}", flush=True)
            if got != PSD_DDS_FIXTURES[name]:
                raise RuntimeError(f"phase 25a: {name} is not read as Pillow reads it: {got}")

        # ---- (b) the 4K PSD and BC7 DDS decoded --------------------------------------
        hw, seed, noise = big
        lv = fx.levels(hw, seed, noise=noise)
        t0 = time.perf_counter()
        files = {"psd": fx.psd_4k(lv), "dds": fx.bc7_4k(hw, BC7_4K_SEED)}
        print(f"phase 25b 4K PSD and BC7 DDS written: {time.perf_counter() - t0:.3f} s "
              f"(tests/torch_codec_fixtures.py)", flush=True)
        if sha(files["dds"]) != BC7_4K[0]:
            raise RuntimeError("phase 25b: the 4K BC7 file is not the pinned one")
        for kind, data in files.items():
            best = float("inf")
            for _ in range(PSD_DDS_REPEATS):
                t0 = time.perf_counter()
                arr, _ = decoders[kind](data)
                best = min(best, time.perf_counter() - t0)
            ok = np.array_equal(arr, lv) if kind == "psd" else sha(arr.tobytes()) == BC7_4K[1]
            what = "PackBits RGB PSD" if kind == "psd" else "DX10 BC7 DDS"
            print(f"phase 25b {what} {hw[1]}x{hw[0]}: {len(data)} bytes; decode {best:.4f} s "
                  f"(best of {PSD_DDS_REPEATS}; {arr.size / 1e6 / best:.1f} MB/s of samples, "
                  f"{len(data) / 1e6 / best:.2f} MB/s of file); "
                  f"{'== its levels' if kind == 'psd' else '== Pillow digest'}: {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"phase 25b: the 4K {what} decodes to other pixels")

        # ---- (c) spec of the PSD against the same levels as a PNG --------------------
        src = os.path.join(tmp, "still.psd")
        with open(src, "wb") as f:
            f.write(files["psd"])
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, lv / 255.0)
        sh, sw = hw
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        out = {k: os.path.join(tmp, f"spec_{k}.png") for k in ("ref", "psd")}
        with _policy("i8@1e-5"):
            for name, inp in (("ref", ref), ("psd", src)):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "psd")
                print(f"phase 25c spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 25c spec {name} launched {got}, expected {spec_i8}")
            ok = same(out["ref"], out["psd"])
            print(f"phase 25c spectrum from the PSD == from the PNG: {ok}", flush=True)
            if not ok:
                raise RuntimeError("phase 25c: the PSD's spectrum differs from the PNG's")

            # ---- (d) ispec to DDS, the PPM route's pixels, Pillow's 4K DDS -------------
            back = {}
            for ext in ("dds", "ppm"):
                back[ext] = os.path.join(tmp, f"back.{ext}")
                fn = lambda o=back[ext]: _run_tool(  # noqa: E731
                    torch, ispec, list(device_args)
                    + ["-t", "flat", "-G", "1000", out["psd"], o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=ext == "dds")
                print(f"phase 25d ispec to {ext} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 25d ispec to {ext} launched {got}")
        with open(back["ppm"], "rb") as f:
            arr = imgcodecs.decode_pnm(f.read())[0]
        with open(back["dds"], "rb") as f:
            ok = f.read() == dds.encode_dds(arr)
        print(f"phase 25d ispec's DDS == encode_dds of the PPM's pixels: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 25d: ispec's DDS is not encode_dds's bytes")
        t0 = time.perf_counter()
        data = dds.encode_dds(lv)
        enc_s = time.perf_counter() - t0
        ok = sha(data) == DDS_4K
        print(f"phase 25d encode_dds {sw}x{sh}: {len(data)} bytes in {enc_s:.4f} s "
              f"({lv.size / 1e6 / enc_s:.1f} MB/s of RGB); == Pillow's digest: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"phase 25d: the 4K DDS write is not Pillow's: {sha(data)}")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"psd_dds {layout}{nd} {m}x{k}")
    wall = time.perf_counter() - t_phase
    print(f"phase 25 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 26: JPEG 2000 read by the port's own codec (io/jpeg2000.py, native/j2k.cpp) ---

# name -> (sha256 of the file, of the JAX package's read_image(..., "RGBA")
# float64 pixels; for the 4K goldens of Pillow's convert("RGB") samples)
J2K_FIXTURES = {
    "j2k_cmyk.jp2":
        ("79be71ce92c4fbcf0487aca7582a5d2d9169c6e5dcbaf552bbfaf43169d3437d",
         "50f6c6fbb1e9556bd64623a0e47b4bf1da17f0df14c56505aae100b6510d209f"),
    "j2k_gray16.jp2":
        ("874279a2a95b373de4f93b77a58932af45481d7ea0cc08ba9a735fa24b568bf1",
         "107f2e1c0de2734fd4b22616627d0972b5b855dd09de56a7533c27a629d0d4ad"),
    "j2k_index.j2k":
        ("5b39b975713d82f6591bd78cb6de59ad61e7ee28ea2c1e80a3a59018802abe14",
         "58f94928ebf0b27fe348547d590345a19d96e54854920b6f95db06c0b112702e"),
    "j2k_la_cprl.j2k":
        ("834a0d0d1d7e871523fb47e8f186ec0db8f3d5c9a7e7d1576a07122fa60096c2",
         "9383cdac665ef02b6cee87fbfeee5748568e10ed3b06096e254c052d8b617e79"),
    "j2k_layers.jp2":
        ("732014e8c702332b376899a95bdf18a8b0e779ae971f82fd4626f37926d01048",
         "f7cd4b59d523abfa1d17118a65e304fb8b088859061e3788a69d30cf7d15ad47"),
    "j2k_pclr.jp2":
        ("23a4b27d10dbbfe514cd481ee023cbab9a256bf7be17ce890c5ddf0fdd85af3d",
         "ca342f762d64a24cb7ad2d2fdf9b3b942b9036c1e4418cdc2e122dae8160527f"),
    "j2k_rgb_irreversible_mct.jp2":
        ("747c2dc51ea4c2ad7ef4e51a653dee12254a75a9397cbc3b4a7f742fca8f49c8",
         "9c8aaa9b872ca14d4fd2908c309d250082dab93f375456d01ce949e83bfbad08"),
    "j2k_rgb_lossless.jp2":
        ("8c75e9217e0622a5ec723e6fcafe22f1cb5d48f35ee35564636515c718cbfd4a",
         "d6804c231409f7056bed7a908e3c8b66520932367683746ba7eacf08fe8c4e8e"),
    "j2k_rgba_tiles.j2k":
        ("fd4293db99cba9580a36b1d1d37e8fa853b7ec4ad7fe36f1275de46079f13244",
         "0884f0d0555d3263d94b46ea78c0603d2d9cab3a2700cae32480216df670bc11"),
    "j2k_rpcl_precincts.jp2":
        ("d4d19b959af294db762c37af775e9e5872aef1a13e245c6cf8ba2fecc3979901",
         "774459034d00e6317b4f181a4846986827b4f0c7f631f599111027f6397b2a69"),
    "j2k_signed12.j2k":
        ("a5517c673ba9a376abdc7db7f7e7b5752ce5688f58bd6145da2db380f65b8b98",
         "cce3db30cf5ce81299e4270f83ee865afb8ad45182edd47c3cf8913278c2cb67"),
    "j2k_sycc.jp2":
        ("519ebeac209a736884d7704971cfc34a58ac21c3d9ea804fda4c0cd0321b2906",
         "c4687ebcd9a803fbd0eea55490c26a718f07160e618de38e1d6f6b4f6d1c3101"),
    "j2k_4k_irreversible.jp2":
        ("eb89a1e12984c30c28b1021af380eb04905417bca811e37e6b1f01d94c156ee9",
         "3f6611472f401ddb00a6e87650cfd637eea99d45eb02efe5e4cd6740c1e0aa62"),
    "j2k_4k_lossless.jp2":
        ("b7a4ab73102ac0770bea6aad1a30e30175f8399ef5a89f3ec3392cbe82c3730a",
         "cf3dbfefad9371baa26077ed2d1aa8c57478573fb6403fadc7519c0cde039cf3"),
}
J2K_REPEATS = 2                   # (b): the 4K decodes, best of
J2K_SPEC = "j2k_4k_irreversible.jp2"


def _j2k_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, spec_file=J2K_SPEC,
               device_args=()) -> dict:
    """Main path 22: JPEG 2000 read by the port's own codec
    (``io/jpeg2000.py`` on ``native/j2k.cpp``).  (a) Every fixture of
    ``j2k_fixtures()`` (Pillow's goldens and the edits made of them)
    through ``images._decoder`` to ``decode_j2k``, file and pixels equal to
    the JAX package's digests; (b) the two 3840x2160 goldens decoded (best
    of ``J2K_REPEATS``) to Pillow's digests; (c) spec of ``spec_file`` at
    ``i8@1e-5`` against the same levels as a PNG.  Returns the kernels' launches over the runs
    of the JPEG 2000 files."""
    import hashlib

    from dspfun_tpu_torch.io import images, jpeg2000
    from dspfun_tpu_torch.tools import spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    same = lambda a, b: open(a, "rb").read() == open(b, "rb").read()  # noqa: E731
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg2000._load()
    print(f"phase 26 native/j2k.cpp load: {time.perf_counter() - t0:.2f} s", flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    goldens = {}
    for name in fx.j2k_golden_names():
        with open(os.path.join(gold, name), "rb") as f:
            goldens[name] = f.read()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_j2k_") as tmp:
        # ---- (a) the fixtures to the JAX package's digests -------------------------
        made = fx.j2k_fixtures(goldens)
        if sorted([*made, *fx.J2K_4K]) != sorted(J2K_FIXTURES):
            raise RuntimeError(f"phase 26a: the fixtures are not {sorted(J2K_FIXTURES)}")
        for name, data in sorted(made.items()):
            if images._decoder(data) is not jpeg2000.decode_j2k:
                raise RuntimeError(f"phase 26a: {name} does not take the port's JPEG 2000 "
                                   f"decoder")
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            got = (sha(data), fx.rgba_digest(img.pixels))
            print(f"phase 26a {name} {img.width}x{img.height} depth {img.depth}: {len(data)} "
                  f"bytes; read {dec_s:.4f} s; file and pixels == the JAX package's digests: "
                  f"{got == J2K_FIXTURES[name]}", flush=True)
            if got != J2K_FIXTURES[name]:
                raise RuntimeError(f"phase 26a: {name} is not read as Pillow reads it: {got}")

        # ---- (b) the 4K goldens decoded ------------------------------------------------
        decoded, plain_s = {}, {}
        for name in fx.J2K_4K:
            data = goldens[name]
            if images._decoder(data) is not jpeg2000.decode_j2k:
                raise RuntimeError(f"phase 26b: {name} does not take the port's decoder")
            best = float("inf")
            for _ in range(J2K_REPEATS):
                t0 = time.perf_counter()
                arr, depth = jpeg2000.decode_j2k(data)
                best = min(best, time.perf_counter() - t0)
            decoded[name] = arr
            plain_s[name] = round(best, 4)
            got = (sha(data), fx.rgb_digest(arr))
            print(f"phase 26b {name} {arr.shape[1]}x{arr.shape[0]}x{arr.shape[2]} ({len(data)} "
                  f"bytes): decode {best:.4f} s (best of {J2K_REPEATS}), "
                  f"{arr.size / 1e6 / best:.1f} MB/s of samples, {len(data) / 1e6 / best:.2f} "
                  f"MB/s of file; file and pixels == Pillow's digests: "
                  f"{got == J2K_FIXTURES[name]}", flush=True)
            if got != J2K_FIXTURES[name] or depth != 8:
                raise RuntimeError(f"phase 26b: {name} is not decoded as Pillow decodes it: {got}")

        # ---- (c) spec of the 4K JP2 against the same levels as a PNG -------------------
        src = os.path.join(tmp, "still.jp2")
        with open(src, "wb") as f:
            f.write(goldens[spec_file])
        arr = decoded[spec_file]
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, arr / 255.0)
        sh, sw = arr.shape[:2]
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        out = {k: os.path.join(tmp, f"spec_{k}.png") for k in ("ref", "jp2")}
        with _policy("i8@1e-5"):
            for name, inp in (("ref", ref), ("jp2", src)):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "jp2")
                print(f"phase 26c spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 26c spec {name} launched {got}, expected {spec_i8}")
            ok = same(out["ref"], out["jp2"])
            print(f"phase 26c spectrum from {spec_file} == from the PNG: {ok}", flush=True)
            if not ok:
                raise RuntimeError("phase 26c: the JP2's spectrum differs from the PNG's")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"jpeg2000 {layout}{nd} {m}x{k}")
    wall = time.perf_counter() - t_phase
    print(f"phase 26 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes), "decode_4k_s": plain_s}


# phase 27: arithmetic-coded JPEG read by the port's own codec (io/jpeg.py,
# native/jpeg.cpp:jpg_decode_arith) -------------------------------------------------

# name -> (sha256 of the golden, of Pillow's convert("RGB") samples); the
# goldens are written by tests/torch_codec_fixtures.py:arith_goldens with
# libjpeg's arithmetic coder (tests/jpeg_arith_writer.c) and pinned by
# tests/test_torch_jpeg_arith.py
ARITH_FIXTURES = {
    "arith_seq_420.jpg": ("6cc6f2c285a6085d24d03fbf10e3de05cda956892f5d16fe1925dce7cd00ecc7",
                          "b90c8df1a83ae46a02a25fa98d70e78b1081469b6e6dda7acee804ef104ecd07"),
    "arith_seq_444_rst.jpg": ("5f7af69db38b8d6db9e714afb51a83f3729bb475ea64e9e454ddd7361b8e1f19",
                              "91c9650fbd43ff9bd50ab7a01cac085ffe53c8cdc3b6cfd9a81dbc85d3c75b5f"),
    "arith_prog_gray_dac.jpg": (
        "1c96885cc5141ef5b244666d80d7d8db2a2f67b2c4ab6fcbfd2c4e1445c4e7d4",
        "8bc188aabf9b4c55974cc32e20fad9d3c51935e5b7a1cf76dac02d6c83f0c0b5"),
    "arith_cmyk_rows.jpg": ("c0e86d07a1be6cf5df612ef04fd308f48fece13a87eb8485b8225787f292271d",
                            "c8571490fbaedd120e6a33d43eb54f763b9df522489ff91c9607403c2233cb76"),
    "arith_ycck_prog.jpg": ("4ef1f94520cafe5933df768f0499f46a57fea7e338f2b8ddaa58e79cee03acc6",
                            "6116f06f87d8206f4fead8349479f923ffb169039231d669e729a26e94b81002"),
    "arith_prog_short.jpg": ("0a2d7eb462eaf281be96b7446d346bff60522268d0212d1d204d61c00d8b7850",
                             "e1bf873f75a4d1546e0c3cd64e1187f9607633cdc074b59a6ca0f6f8a564151c"),
    "arith_tiles.tif": ("7a8e8ef86ad412e26c91bb4658ed67589f286a09cd89e90bf5f1ad59715ef5cc",
                        "4997b945f36e397bb6c97562bf80ecd50a3af948c5011d09de2feb19083b086b"),
    "arith_gray_strips.tif": ("e6d96cac6e44798afe6876711f27fc81a7047f0df5a8cb19ee2f2390887d6f47",
                              "3e9a02b066874bb9ada60fd04982807c8ca2c53d835ed42404592ed075173047"),
    # codec_prog_4k.jpg's coefficients: its pixels are CODEC_FIXTURES' digest
    "arith_4k.tif": ("60fd07a180c8a04c81de5d0ae66d2ccccc92a8086ed59036d87cda8c2525a113",
                     "d7027c43d242312e4986ffad0ce6a4be67e11946f7806210e8a5e848971ebb50"),
}
ARITH_PAST = "arith_seq_444_rst.jpg"   # (b): padded to ARITH_PAST_SIZE bytes, it raises
ARITH_PAST_SIZE = 65537
ARITH_4K = "arith_4k.tif"
ARITH_REPEATS = 2                 # (c): the 4K decode, best of


def arith_past_window(data: bytes, size: int = ARITH_PAST_SIZE) -> bytes:
    """A JPEG padded to ``size`` bytes by a COM segment after its SOI: its
    scans move so far that the last needs bytes past the first 65,536, the
    chunk Pillow hands libjpeg (``jpeg.PILLOW_CHUNK``)."""
    n = size - len(data)
    return data[:2] + b"\xff\xfe" + (n - 2).to_bytes(2, "big") + bytes(n - 4) + data[2:]


def _arith_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, huffman_4k_s=None,
                 jpg_spectrum=None, spec_pair=None, device_args=()) -> dict:
    """Main path 23: arithmetic-coded JPEG through the port's own codec
    (``io/jpeg.py`` on ``native/jpeg.cpp:jpg_decode_arith``).  (a) Every
    golden of ``ARITH_FIXTURES`` through ``images._decoder`` to
    ``decode_jpeg`` or ``decode_tiff``, file and pixels equal to Pillow's
    digests (sequential, progressive, conditioned, restarts, CMYK, YCCK, a
    short progressive file, tiles and strips of JPEG-in-TIFF); (b) a golden
    padded past Pillow's 65,536-byte chunk raises, as Pillow raises; (c) the
    3840x2160 JPEG-in-TIFF of ``codec_prog_4k.jpg``'s coefficients decoded
    (best of ``ARITH_REPEATS``) to that file's pixels, beside phase 17's
    Huffman decode of it (``huffman_4k_s``); (d) spec of the TIFF at
    ``i8@1e-5`` equal to the spectrum of ``codec_prog_4k.jpg`` (phase 17's,
    the sha256 ``jpg_spectrum``; run here where None; ``spec_pair``: a
    TIFF's bytes and the path of a JPEG of the same coefficients in their
    place, for a rehearsal on the CPU).  Returns the kernels' launches over
    the run of the TIFF."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, jpeg
    from dspfun_tpu_torch.tools import spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    jpeg._load()
    print(f"phase 27 native/jpeg.cpp load: {time.perf_counter() - t0:.2f} s", flush=True)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    goldens = {}
    for name in ARITH_FIXTURES:
        with open(os.path.join(gold, name), "rb") as f:
            goldens[name] = f.read()
    decoders = {".jpg": jpeg.decode_jpeg, ".tif": imgcodecs.decode_tiff}

    # ---- (a) the goldens to Pillow's digests ---------------------------------------
    for name, data in goldens.items():
        if name == ARITH_4K:
            continue
        if images._decoder(data) is not decoders[name[-4:]]:
            raise RuntimeError(f"phase 27a: {name} does not take the port's codec")
        t0 = time.perf_counter()
        arr, depth = decoders[name[-4:]](data)
        dec_s = time.perf_counter() - t0
        kind = ""
        if name.endswith(".jpg"):
            frame = jpeg.decode_coefficients(data)[0]
            kind = (f"SOF{frame.marker - 0xC0}, {len(frame.components)} components"
                    f"{', smoothed' if frame.smoothed else ''}; ")
        got = (sha(data), fx.rgb_digest(arr))
        print(f"phase 27a {name} {arr.shape[1]}x{arr.shape[0]}x{arr.shape[2]} ({kind}{len(data)} "
              f"bytes): decode {dec_s:.4f} s; file and pixels == Pillow's digests: "
              f"{got == ARITH_FIXTURES[name]}", flush=True)
        if got != ARITH_FIXTURES[name] or depth != 8:
            raise RuntimeError(f"phase 27a: {name} is not decoded as Pillow decodes it: {got}")

    # ---- (b) past Pillow's chunk: a ValueError, as Pillow raises ----------------------
    past = arith_past_window(goldens[ARITH_PAST])
    try:
        jpeg.decode_jpeg(past)
        raised = ""
    except ValueError as e:
        raised = str(e)
    ok = "broken data stream" in raised
    print(f"phase 27b {ARITH_PAST} padded to {len(past)} bytes raises, as Pillow does: {ok} "
          f"({raised[:80]})", flush=True)
    if not ok:
        raise RuntimeError("phase 27b: an arithmetic JPEG past Pillow's chunk does not raise")

    # ---- (c) the 4K arithmetic JPEG-in-TIFF ---------------------------------------------
    data = goldens[ARITH_4K]
    if images._decoder(data) is not imgcodecs.decode_tiff:
        raise RuntimeError(f"phase 27c: {ARITH_4K} does not take the port's TIFF codec")
    best = float("inf")
    for _ in range(ARITH_REPEATS):
        t0 = time.perf_counter()
        arr, _ = imgcodecs.decode_tiff(data)
        best = min(best, time.perf_counter() - t0)
    got = sha(np.ascontiguousarray(arr).tobytes())
    ok = got == CODEC_FIXTURES["codec_prog_4k.jpg"][1] == ARITH_FIXTURES[ARITH_4K][1]
    huffman = "not measured" if huffman_4k_s is None else \
        f"{huffman_4k_s:.4f} s, {arr.size / 1e6 / huffman_4k_s:.1f} MB/s"
    print(f"phase 27c {ARITH_4K} {arr.shape[1]}x{arr.shape[0]}x{arr.shape[2]} (SOF9 in one "
          f"strip, {len(data)} bytes): decode {best:.4f} s (best of {ARITH_REPEATS}), "
          f"{arr.size / 1e6 / best:.1f} MB/s of samples; phase 17's Huffman decode of "
          f"codec_prog_4k.jpg {huffman}; pixels == codec_prog_4k.jpg's: {ok}", flush=True)
    if not ok:
        raise RuntimeError(f"phase 27c: {ARITH_4K} decodes to other pixels: {got}")

    # ---- (d) spec of the TIFF against spec of codec_prog_4k.jpg -------------------------
    jpg = os.path.join(gold, "codec_prog_4k.jpg")
    if spec_pair is not None:
        (data, jpg), jpg_spectrum = spec_pair, None
        arr, _ = imgcodecs.decode_tiff(data)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_arith_") as tmp:
        src = os.path.join(tmp, "still.tiff")
        with open(src, "wb") as f:
            f.write(data)
        sh, sw = arr.shape[:2]
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        runs = {"tif": src}
        if jpg_spectrum is None:
            runs["jpg"] = jpg
        spectra = {"jpg": jpg_spectrum}
        with _policy("i8@1e-5"):
            for name, inp in runs.items():
                o = os.path.join(tmp, f"spec_{name}.png")
                fn = lambda inp=inp, o=o: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "tif")
                with open(o, "rb") as f:
                    spectra[name] = sha(f.read())
                print(f"phase 27d spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 27d spec {name} launched {got}, expected {spec_i8}")
    ok = spectra["tif"] == spectra["jpg"]
    print(f"phase 27d spectrum of {ARITH_4K} == of codec_prog_4k.jpg"
          f"{'' if 'jpg' in runs else ' (phase 17b)'}: {ok}", flush=True)
    if not ok:
        raise RuntimeError("phase 27d: the arithmetic TIFF's spectrum differs from the JPEG's")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"arith {layout}{nd} {m}x{k}")
    wall = time.perf_counter() - t_phase
    print(f"phase 27 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 28: old-style JPEG, 12-bit JPEG, ThunderScan and RLE-W TIFF read by the
# port's own codecs (io/ojpeg.py, io/imgcodecs.py, native/jpeg.cpp, tiff.cpp, fax.cpp)

# name -> (sha256 of the golden, of Pillow's samples: its I;16 array for a
# 12-bit file, else its convert("RGB")); the goldens are written by
# tests/torch_codec_fixtures.py:ojpeg_goldens and more_tiff_goldens and
# pinned by tests/test_torch_tiff_ojpeg.py and test_torch_tiff_12bit.py
OJPEG_FIXTURES = {
    "ojpeg_jif_420.tif": ("908e9813640641994f3b82c258660d59915fb71f0c155b15ca1369febbde425d",
                          "6098644d4e3a069ac9b3cb5d667cf6c15e56b0750ac0fc8e1d99cfe898f07e58"),
    "ojpeg_tables_422_rst.tif": (
        "d72700d4ac241150b2e46fd1adce0574f58b662971acf5f83bdd0ca8e9cf8587",
        "257ad5826a96259536c5452e58fc4a2fadbcbaf908b8ecd67901e548ad0a605c"),
    "ojpeg_jif_420_mm.tif": ("b17138b4e7337d80dff81b26ebab6f726f60af381a0cb97363a6dffeec09daeb",
                             "4fee9cef04b19c9e2c3896d815b5ebf31670736800d9790bb262560300997aa9"),
    "ojpeg_gray_tables.tif": ("ee73d49fe9a9db9694710d578a5f3909400625aa703aae3b165f5e99ad9553c6",
                              "71b553c5aaf2ed370f8cbffd01cde84f184358ec8c51c0ccb80d9132690bc918"),
    "ojpeg_jif_444_refbw.tif": (
        "32c1e42a53041b0fc9c754aee97cb16618682ec4a7581d07c87c76b3f851bb00",
        "d6e9f60466710cbefee3ab1ba26121d1b871ad51ba145060f39a015ac45727d7"),
    "tiff12_sof1_strips.tif": ("7562d9553575a6fd3072760210caa804d9f04d909da51a81c2fe0d40a3a921b5",
                               "001228d2779bfc95ac4f85195a8fce5af27641abb3904313bbafbcb6ace916e4"),
    "tiff12_sof3_tiles.tif": ("13992c1337e7ad9248d13a031322bbb31447167bfd8abb53d575c679c1d84665",
                              "ad28267a69ce3213326cdc022e103d19345b4dcef53c532d5da883add2f34321"),
    "thunderscan.tif": ("b842a69771609465b200205ffafba6e398506d3960097075653bc7981cf58374",
                        "02e025e4c56bceef5554ce638a477b1da91de8a1f8e52cb14419db386dbe1450"),
    "rlew_fill2.tif": ("8adefb432be97c9ccad8f08f110dcea7a598c846819ca17be802f2786f446e21",
                       "aff4dcdf588e2d65e1d19b6508f8cb9357a440166e92696e5bff3e0cdab8b890"),
    # Pillow's baseline JPEG of codec_prog_4k.jpg's levels in 64-row strips
    "ojpeg_4k.tif": ("4ebe118c90befc1384e6ff387916fc44e4b1e17a87e121e8753a83a970643122",
                     "3b571e0ea07fb2ab0ebdb09d90766d4f8df55fffad0c89604591f86a47416f54"),
}
OJPEG_4K = "ojpeg_4k.tif"
OJPEG_REPEATS = 2                 # (b), (c): the 4K decodes, best of
TIFF12_4K_SEED = 62               # (c): tests/torch_codec_fixtures.py:gray12's seed
TIFF12_4K_NOISE = 8.0             # and noise, in 12-bit levels
# (c): sha256 of the 4K 12-bit file (one SOF1 strip of gray12's 3840x2160
# levels) and of Pillow's I;16 samples of it (tests/test_torch_tiff_12bit.py)
TIFF12_4K = ("2c8eaa9a93b7190ce9868fdd1e89c456b84b2b6e28113ee78299d361ed69a78b",
             "3cc6d6d86a5b303f3e285981629c0600e482e975901f31b7983955c1b8bbbfd8")


def _ojpeg_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, jpeg_tiff_4k_s=None,
                 device_args=(), big=(H, W)) -> dict:
    """Main path 24: old-style JPEG, 12-bit JPEG-in-TIFF, ThunderScan and
    RLE-W TIFF through the port's own codecs.  (a) Every golden of
    ``OJPEG_FIXTURES`` through ``images._decoder`` to ``decode_tiff``, file
    and samples equal to Pillow's digests; (b) the 3840x2160 old-style JPEG
    (``OJPEG_4K``, 34 strips) decoded (best of ``OJPEG_REPEATS``) beside
    phase 20b's 4K JPEG-in-TIFF decode (``jpeg_tiff_4k_s``); (c) a 4K
    12-bit gray JPEG-in-TIFF written here (one SOF1 strip) and decoded to
    Pillow's digest; (d) spec of the old-style JPEG at ``i8@1e-5``: kernels
    #1-#2 once each, its spectrum equal to that of a PNG of the same
    decoded pixels.  ``big`` other than 4K: a rehearsal of (c) at that size,
    (d) on the 4K file's top-left crop, with no digest to hold (c) to.
    Returns the kernels' launches over the run of the TIFF."""
    import hashlib

    from dspfun_tpu_torch.io import images, imgcodecs, jpeg
    from dspfun_tpu_torch.tools import spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    goldens = {}
    for name in OJPEG_FIXTURES:
        with open(os.path.join(gold, name), "rb") as f:
            goldens[name] = f.read()

    # ---- (a) the goldens to Pillow's digests ---------------------------------------
    for name, data in goldens.items():
        if images._decoder(data) is not imgcodecs.decode_tiff:
            raise RuntimeError(f"phase 28a: {name} does not take the port's TIFF codec")
        if name == OJPEG_4K:
            continue
        t0 = time.perf_counter()
        arr, depth = imgcodecs.decode_tiff(data)
        dec_s = time.perf_counter() - t0
        got = (sha(data), fx.port_digest(arr))
        print(f"phase 28a {name} {arr.shape[1]}x{arr.shape[0]}x{arr.shape[2]} {arr.dtype} "
              f"({len(data)} bytes): decode {dec_s:.4f} s, depth {depth}; file and samples == "
              f"Pillow's digests: {got == OJPEG_FIXTURES[name]}", flush=True)
        if got != OJPEG_FIXTURES[name]:
            raise RuntimeError(f"phase 28a: {name} is not decoded as Pillow decodes it: {got}")

    # ---- (b) the 4K old-style JPEG ----------------------------------------------------
    data = goldens[OJPEG_4K]
    best = float("inf")
    for _ in range(OJPEG_REPEATS):
        t0 = time.perf_counter()
        arr, _ = imgcodecs.decode_tiff(data)
        best = min(best, time.perf_counter() - t0)
    ok = (sha(data), fx.port_digest(arr)) == OJPEG_FIXTURES[OJPEG_4K]
    beside = "not measured" if jpeg_tiff_4k_s is None else \
        f"{jpeg_tiff_4k_s:.4f} s, {arr.size / 1e6 / jpeg_tiff_4k_s:.1f} MB/s"
    print(f"phase 28b {OJPEG_4K} {arr.shape[1]}x{arr.shape[0]}x{arr.shape[2]} (4:2:0 in 34 "
          f"strips, {len(data)} bytes): decode {best:.4f} s (best of {OJPEG_REPEATS}), "
          f"{arr.size / 1e6 / best:.1f} MB/s of samples; phase 20b's 4K JPEG-in-TIFF decode "
          f"{beside}; pixels == Pillow's digest: {ok}", flush=True)
    if not ok:
        raise RuntimeError("phase 28b: the 4K old-style JPEG decodes to other pixels")
    pixels = arr

    # ---- (c) a 4K 12-bit gray JPEG-in-TIFF -------------------------------------------
    t0 = time.perf_counter()
    data12 = fx.tiff12(fx.gray12(big, TIFF12_4K_SEED, TIFF12_4K_NOISE), "sof1")
    enc_s = time.perf_counter() - t0
    if images._decoder(data12) is not imgcodecs.decode_tiff:
        raise RuntimeError("phase 28c: the 12-bit TIFF does not take the port's TIFF codec")
    best = float("inf")
    for _ in range(OJPEG_REPEATS):
        t0 = time.perf_counter()
        arr, depth = imgcodecs.decode_tiff(data12)
        best = min(best, time.perf_counter() - t0)
    got = (sha(data12), fx.port_digest(arr))
    ok = got == TIFF12_4K if big == (H, W) else arr.shape == (*big, 1)
    print(f"phase 28c 12-bit SOF1 JPEG-in-TIFF {big[1]}x{big[0]} ({len(data12)} bytes, written "
          f"in {enc_s:.2f} s): decode {best:.4f} s (best of {OJPEG_REPEATS}), "
          f"{arr.size / 1e6 / best:.1f} M samples/s, depth {depth}; file and samples == "
          f"Pillow's digests: {ok}", flush=True)
    if not ok or depth != 16:
        raise RuntimeError(f"phase 28c: the 4K 12-bit TIFF decodes otherwise: {got}")

    # ---- (d) spec of the old-style JPEG against a PNG of its pixels ------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ojpeg_") as tmp:
        src = os.path.join(tmp, "still.tif")
        if big != (H, W):       # a rehearsal: the top-left crop, as an old-style JPEG too
            pixels = np.ascontiguousarray(pixels[:big[0], :big[1]])
            data = fx.make_ojpeg(jpeg.encode_jpeg(pixels), big[1], big[0], "jif")
            pixels = imgcodecs.decode_tiff(data)[0]
        with open(src, "wb") as f:
            f.write(data)
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, pixels / 255.0)
        sh, sw = pixels.shape[:2]
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        out = {k: os.path.join(tmp, f"spec_{k}.png") for k in ("ref", "tif")}
        with _policy("i8@1e-5"):
            for name, inp in (("ref", ref), ("tif", src)):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "tif")
                print(f"phase 28d spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 28d spec {name} launched {got}, expected {spec_i8}")
        with open(out["ref"], "rb") as f, open(out["tif"], "rb") as g:
            ok = f.read() == g.read()
    print(f"phase 28d spectrum of the old-style JPEG == of the PNG: {ok}", flush=True)
    if not ok:
        raise RuntimeError("phase 28d: the old-style JPEG's spectrum differs from the PNG's")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"ojpeg {layout}{nd} {m}x{k}")
    wall = time.perf_counter() - t_phase
    print(f"phase 28 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


# phase 29: JPEG 2000's rest read by the port's own codec: POC, SOP/EPH, the code-block
# style switches, RGN, COC/QCC and sub-sampled components (io/jpeg2000.py, native/j2k.cpp)

# name -> (sha256 of the golden, of the JAX package's read_image(..., "RGBA")
# float64 pixels; for the 4K goldens of Pillow's convert("RGB") samples); the
# goldens are written by tests/torch_codec_fixtures.py:j2k_more_goldens with
# Pillow's own OpenJPEG and pinned by tests/test_torch_jpeg2000_more.py
J2K_MORE_FIXTURES = {
    "j2k_cinema4k.jp2":
        ("5c6f4ea47936c1065862b297a883bff2c85c8a058176c1dcc732c563956732c3",
         "330cdda96dc9a18b068421c452220b96a28fd11760b21ce0534588327b3afa93"),
    "j2k_poc_tiles.j2k":
        ("5e4e622f412f284bf4de5fbf1ebf83b166694f3827ec3b4cb65bebe95777be78",
         "8a74dee5d7166ef2c4bde4fa129dcc4f546cad08798d4122649981c3e80c8e7c"),
    "j2k_poc_layers.j2k":
        ("f767b5e5529a3fedc38c09999caa0bf1f9af9fc267aa073fbac1306eda2095da",
         "7d5621eb645f6aefd58391403bd325e4374cd000260c65c74d2e47e39a2f82b1"),
    "j2k_sop_eph.j2k":
        ("17a7515a2e6264b7ef25add96eea0ba57e6db6f39e75d7d28b2082aeb36f9935",
         "8a74dee5d7166ef2c4bde4fa129dcc4f546cad08798d4122649981c3e80c8e7c"),
    "j2k_style1_53.j2k":
        ("df11b929dfba345c775620bfcd2ae42910bc3a0f14a45e2a97a2fcafbf4c2313",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style1_97.j2k":
        ("f74027f8e5a91642373b635c46d9adffb54510fff91a82aecbb7d1ec2bf4ef25",
         "a043162c54f1916527d6e99afd8bf20013b5acbdb93823d61be93f5715bd7661"),
    "j2k_style2_53.j2k":
        ("81db861d3509bd43bd0917f888dbff16d95c3852088d0129f6f1fcaf56fce538",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style2_97.j2k":
        ("7d12fef5df7b35008c9485af12b090826849f47fb519220e03a18031eb99974d",
         "4accf2bd3d87bb6ae76ef236957e90fcbcaaa25f3a340730620b42ee6e9062ae"),
    "j2k_style4_53.j2k":
        ("fe711b56bc3d0975112b8bfd30f3a226d06aa6b3f70640d4b428966164d4b358",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style4_97.j2k":
        ("d396f060b64c032101bcaadc0cf1242ba8c5839e3c0abd531b56ad1f1d53e6b1",
         "39d270d9b588d4ede60f2c609a9891d2f7da47713f986fc2bef038c7ddaad581"),
    "j2k_style8_53.j2k":
        ("991ca55e5eb90b24e44b635333ad7577e4b944286de396e2403551af02f1578f",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style8_97.j2k":
        ("9d1e3af73ca6358fe52141076741b73b21647524e194121c5caace0540ed8834",
         "3cf8ba99f947b3c99482c89687b48c59adfca130c610faaf0ad1e4c7db769a61"),
    "j2k_style16_53.j2k":
        ("d91513ba68e340a3d92817ee851ed4198b140feccdf6ed10835e21a87879d35c",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style16_97.j2k":
        ("824e5e440c05cfee62a7b491502a479bbaca5e1c8b77120081cdf2c49ff29ac5",
         "0a7e8b03de76ccd258adb8fb7bdc9c33437f61fbadd56a7d0f882341c982e11c"),
    "j2k_style32_53.j2k":
        ("7ef90f890689326b250ec3f46aed19efa722acae343faaec6e4ad38b3f5cbb55",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style32_97.j2k":
        ("4685de90e15f5414b6199d9bb8793868922a7a0ca691515b39aa0fe5528897c4",
         "cb160cbe266ca9113ad5b0a0c3b78f9710cb3cc9ce8dfea16e1412afb1db6597"),
    "j2k_style63_53.j2k":
        ("63c6e3daac21e8de8bb64f1c418c7fcb66efba290f0d9da0ae17731b03467a3a",
         "6e958b90f0bdf08b344911e82ed70759b154c89178edc1db8a195b083adcf55f"),
    "j2k_style63_97.j2k":
        ("2e42a422679250afb445b933f0ba74eebb62cdd404015d5a3dcbe099bf10db7e",
         "e390e8fbf58b908de2285bb1e5ce7b04d2a7ecf5c616230bc59962c199390a17"),
    "j2k_rgn.j2k":
        ("067745831d44c4af577f2571eff273c0153aee0f736992b131a1457a99372003",
         "8a74dee5d7166ef2c4bde4fa129dcc4f546cad08798d4122649981c3e80c8e7c"),
    "j2k_coc_qcc.j2k":
        ("b6336407b6be8bc5e860aac1aa92be1b6e721fecf0ff027b96b236cd38b6a04d",
         "e15e0b0b1117b53859828d869afab260008111475e7b7b22f22820360a57f89f"),
    "j2k_tile_coc.j2k":
        ("d9f295ab7164875b0618a53367bc35c3dfcb00efa79991076a92351cd53c582e",
         "e15e0b0b1117b53859828d869afab260008111475e7b7b22f22820360a57f89f"),
    "j2k_sub_420.j2k":
        ("58ab1530b3ac38696ad5b1963ab96fe61737c4510cd93d450837c2ae9e26eff4",
         "a02d1aacf6e128bb128018a6fe77f1ecf87830f7914af3cf186175bc09c94e85"),
    "j2k_sub_422_tiles.j2k":
        ("938e08e3ab26e2980105dc140c474e7b1178044cec1e5706d3bef3bafd7aed59",
         "4dc13ccded0a8b7f161500c55ad9c3d2c128921a5fadcc021722c1761ac15f44"),
    "j2k_sycc_420.jp2":
        ("20ffeb65b8279b803dae5ffb74319047492e61783ae9490691c84a7c5ce8d6be",
         "83e39c23e30adac95cd2b5dc52e6edb8f0a23bbd82971d59cd415273ff5380af"),
    "j2k_sub_rgba.j2k":
        ("d3838b1614d161b21c83f28b84e3bb78078254c98651e13c236cf6ad04cde6b8",
         "40f343eb6367a95caf8a3f316f4d2b6528546aac6015c97fea02f3c625f8eb81"),
    "j2k_4k_bypass_termall.j2k":
        ("1fa286b6e1ac5a14e92930fc400843d4f2f845f68efea48215ee0fd88ced56d1",
         "a1af61416c2938af8ca083c01a68983aa22c8ecef7f7357fc0a39d6ff8da841d"),
}
J2K_CINEMA = "j2k_cinema4k.jp2"   # (b), (c): Pillow's cinema4k-24, 4096x2160, a main-header POC
J2K_BYPASS = "j2k_4k_bypass_termall.j2k"   # (b): 3840x2160, bypass and every pass terminated


def _j2k_more_phase(torch, dev, int8mm, block_filter, check_i8mm, fft, plain_4k_s=None,
                    device_args=()) -> dict:
    """Main path 25: JPEG 2000's rest through the port's own codec
    (``io/jpeg2000.py`` on ``native/j2k.cpp``).  (a) Every golden of
    ``J2K_MORE_FIXTURES`` (POCs, SOP/EPH, each code-block style switch,
    RGN, COC/QCC, sub-sampled components) through ``images._decoder`` to
    ``decode_j2k``, file and pixels equal to the JAX package's digests; (b)
    Pillow's 4096x2160 ``cinema4k-24`` file and the 3840x2160 bypass and
    termall file decoded (best of ``J2K_REPEATS``) to Pillow's digests,
    beside phase 26b's plain 4K decodes (``plain_4k_s``); (c) spec of the
    cinema file at ``i8@1e-5``: kernels #1-#2 once each, its spectrum
    equal to that of a PNG of the same decoded pixels.  Returns the
    kernels' launches over the run of the JPEG 2000 file and their shapes."""
    import hashlib

    from dspfun_tpu_torch.io import images, jpeg2000
    from dspfun_tpu_torch.tools import spec

    fx = _fixtures_module()
    count = _Launches(torch, int8mm, block_filter)
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    t_phase = time.perf_counter()
    made = fx.j2k_more_fixtures()
    if sorted(made) != sorted(J2K_MORE_FIXTURES):
        raise RuntimeError(f"phase 29a: the goldens are not {sorted(J2K_MORE_FIXTURES)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_j2k_more_") as tmp:
        # ---- (a) the goldens to the JAX package's digests --------------------------
        for name, data in made.items():
            if images._decoder(data) is not jpeg2000.decode_j2k:
                raise RuntimeError(f"phase 29a: {name} does not take the port's JPEG 2000 "
                                   f"decoder")
            if name in fx.J2K_MORE_4K:
                continue
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            img = images.read_image(path, channels="RGBA")
            dec_s = time.perf_counter() - t0
            got = (sha(data), fx.rgba_digest(img.pixels))
            print(f"phase 29a {name} {img.width}x{img.height} depth {img.depth}: {len(data)} "
                  f"bytes; read {dec_s:.4f} s; file and pixels == the JAX package's digests: "
                  f"{got == J2K_MORE_FIXTURES[name]}", flush=True)
            if got != J2K_MORE_FIXTURES[name]:
                raise RuntimeError(f"phase 29a: {name} is not read as Pillow reads it: {got}")

        # ---- (b) the 4K files decoded, beside phase 26b's ------------------------------
        decoded = {}
        for name in fx.J2K_MORE_4K:
            data = made[name]
            best = float("inf")
            for _ in range(J2K_REPEATS):
                t0 = time.perf_counter()
                arr, depth = jpeg2000.decode_j2k(data)
                best = min(best, time.perf_counter() - t0)
            decoded[name] = arr
            got = (sha(data), fx.rgb_digest(arr))
            print(f"phase 29b {name} {arr.shape[1]}x{arr.shape[0]}x{arr.shape[2]} ({len(data)} "
                  f"bytes): decode {best:.4f} s (best of {J2K_REPEATS}), "
                  f"{arr.size / 1e6 / best:.1f} MB/s of samples; phase 26b's plain 4K decodes "
                  f"{json.dumps(plain_4k_s)}; file and pixels == Pillow's digests: "
                  f"{got == J2K_MORE_FIXTURES[name]}", flush=True)
            if got != J2K_MORE_FIXTURES[name] or depth != 8:
                raise RuntimeError(f"phase 29b: {name} is not decoded as Pillow decodes it: {got}")

        # ---- (c) spec of the cinema file against the same levels as a PNG ---------------
        src = os.path.join(tmp, J2K_CINEMA)
        with open(src, "wb") as f:
            f.write(made[J2K_CINEMA])
        arr = decoded[J2K_CINEMA]
        ref = os.path.join(tmp, "ref.png")
        images.write_image(ref, arr / 255.0)
        sh, sw = arr.shape[:2]
        spec_i8 = {n: 1 for n, side in (("left3", sh), ("right3", sw)) if side >= 256}
        out = {k: os.path.join(tmp, f"spec_{k}.png") for k in ("ref", "jp2")}
        with _policy("i8@1e-5"):
            for name, inp in (("ref", ref), ("jp2", src)):
                fn = lambda inp=inp, o=out[name]: _run_tool(  # noqa: E731
                    torch, spec, list(device_args) + ["-t", "flat", "-G", "1000", inp, o], int8mm)
                (wall, stages, got), _ = count.run(fn, into=name == "jp2")
                print(f"phase 29c spec {name} {sw}x{sh} at i8@1e-5: {wall:.3f} s; stages "
                      f"{_stages(stages)}; launches {json.dumps(got)}", flush=True)
                if got != spec_i8:
                    raise RuntimeError(f"phase 29c spec {name} launched {got}, expected {spec_i8}")
        with open(out["ref"], "rb") as a, open(out["jp2"], "rb") as b:
            ok = a.read() == b.read()
        print(f"phase 29c spectrum from {J2K_CINEMA} == from the PNG: {ok}", flush=True)
        if not ok:
            raise RuntimeError("phase 29c: the cinema file's spectrum differs from the PNG's")
    if check_i8mm is not None:
        for nd, layout, m, k, b, r in sorted(count.shapes):
            check_i8mm(nd, layout, m, k, b, r, f"jpeg2000 more {layout}{nd} {m}x{k}")
    wall = time.perf_counter() - t_phase
    print(f"phase 29 {wall:.1f} s; launches {json.dumps(count.total)}", flush=True)
    return {"launches": count.total, "shapes": sorted(count.shapes)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA card and nothing runs on the CPU",
              file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scipy.fft

    from dspfun_tpu_torch import _build, _hostbuild
    from dspfun_tpu_torch.core.precision import Precision
    from dspfun_tpu_torch.models.fused import (
        filter_plans, fused_filter_2d, lowpass_mask,
    )
    from dspfun_tpu_torch.models.spec_pipeline import (
        SpecChainParams, spec_forward, spec_inverse,
    )
    from dspfun_tpu_torch.ops import block_filter, int8mm

    dev = torch.device("cuda", 0)
    print(f"card: {_card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    fp32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    print(f"float32 matmul settings: {json.dumps(fp32)}", flush=True)
    if fp32["cuda.matmul.allow_tf32"] or fp32["cudnn.allow_tf32"] \
            or fp32["float32_matmul_precision"] != "highest":
        raise RuntimeError("TF32 is enabled; float32 contractions would lose accuracy")

    # the kernels (one nvcc a source) and the host libraries of every phase
    # (one g++ a native/*.cpp), all compiled at once
    t0 = time.perf_counter()
    hosts = [src.stem for src in _hostbuild.build_inputs()]
    with concurrent.futures.ThreadPoolExecutor(len(hosts)) as pool:
        built = pool.map(_hostbuild.load_library, hosts)
        _build.load_library()
        print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})",
              flush=True)
        list(built)
    print(f"host libraries {', '.join(hosts)} built and loaded: {time.perf_counter() - t0:.2f} s "
          "from the start of the build", flush=True)

    @contextlib.contextmanager
    def plain_versions():
        """Route both kernels through their plain versions on the card
        (the comparison baseline); no kernel may launch inside."""
        saved = (int8mm._i8_groups, block_filter._block_filter)
        before = sum(int8mm.LAUNCHES.values()) + sum(block_filter.LAUNCHES.values())
        int8mm._i8_groups = int8mm._i8_groups_plain
        block_filter._block_filter = (lambda *a, split=None:
                                      block_filter._block_filter_plain(*a))
        try:
            yield
        finally:
            int8mm._i8_groups, block_filter._block_filter = saved
        if sum(int8mm.LAUNCHES.values()) + sum(block_filter.LAUNCHES.values()) != before:
            raise RuntimeError("a kernel launched while the plain versions were forced")

    # ---- phase 3: each kernel against its plain version -----------------
    for src in ("int8mm.cu", "block_filter.cu"):
        for line in _ptxas_lines(_build.build_log(), src):
            print(f"ptxas {src} {line}", flush=True)
    mma = _sass_mma_counts(str(_build.library_path()))
    _check_mma(mma, "i8mm_kernel", len(REPLACES))
    _check_mma(mma, "block_filter_kernel", 1)

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {name: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "bound_ms": 0.0,
                    "bound_by": {}, "library_ms": 0.0, "by_shape": {}}
             for name in REPLACES}

    def check_i8mm(nd, layout, m, k, b, r, what):
        """One int8 kernel shape: bit-equal to the plain version, timed
        beside its bound, the plain version and torch._int_mm."""
        kp = int8mm.ceil_to(k, 128)
        a = torch.randint(-64, 65, (nd, m, kp), generator=gen, device=dev, dtype=torch.int8)
        a[:, :, k:] = 0  # the plan's zero padding of K
        xshape = (nd, b, k, r) if layout == "left" else (nd, b, r, k)
        x = torch.randint(-64, 65, xshape, generator=gen, device=dev, dtype=torch.int8)
        name = f"{layout}{nd}"
        y = int8mm._i8_groups_cuda(a, x, layout)
        ref = int8mm._i8_groups_plain(a, x, layout)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        if not torch.equal(y, ref):
            raise RuntimeError(f"{name} {what} M={m} K={k} B={b} R={r}: "
                               f"kernel != plain (max abs diff {err})")
        ms = cuda_ms(lambda: int8mm._i8_groups_cuda(a, x, layout))
        plain_ms = cuda_ms(lambda: int8mm._i8_groups_plain(a, x, layout))
        bound_ms, bound_by = _i8_bound(a, x, layout)
        lib_ms, note = _int_mm_library(torch, a, x, layout, int8mm._W, ref)
        lib = (f"library {lib_ms:.4f} ms ({note}), kernel/library {ms / lib_ms:.3f}"
               if lib_ms else f"library {note}")
        print(f"kernel {name} {what:10s} M={m} K={k} B={b} R={r}: equal, {ms:.4f} ms kernel, "
              f"{plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f} % of bound; {lib}", flush=True)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["by_shape"][what] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": lib_ms}
        return ms, plain_ms, bound_ms, bound_by, lib_ms

    def add(st, ms, plain_ms, bound_ms, bound_by, lib_ms):
        st["ms"] += ms
        st["plain_ms"] += plain_ms
        st["bound_ms"] += bound_ms
        st["bound_by"][bound_by] = st["bound_by"].get(bound_by, 0.0) + bound_ms
        st["library_ms"] = None if lib_ms is None or st["library_ms"] is None \
            else st["library_ms"] + lib_ms

    for nd in (3, 4):
        for layout, m, k, b, r, what in KERNEL_SHAPES:
            res = check_i8mm(nd, layout, m, k, b, r, what)
            if what != "ragged":
                add(stats[f"{layout}{nd}"], *res)
    motion_i8 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
                 "library_ms": 0.0}
    for m, k, r, what in MOTION_I8_SHAPES:
        add(motion_i8, *check_i8mm(3, "right", m, k, 1, r, what))
    for st in (*stats.values(), motion_i8):     # the kind that bounds most of the sum
        st["bound_by"] = max(st["bound_by"], key=st["bound_by"].get)
    torch.cuda.empty_cache()
    bf_stats = _check_block_filter(torch, dev, block_filter, scipy.fft)
    torch.cuda.empty_cache()

    # ---- phase 4: the main path, launches counted -----------------------
    rng = np.random.default_rng(0)
    x_np = rng.random((H, W, C)).astype(np.float32)
    mask_np = lowpass_mask((H, W), cutoff=0.25, boost=1.25, damp=0.0)[:, :, None]
    ref = scipy.fft.dctn(x_np.astype(np.float64), type=2, axes=(0, 1), workers=-1)
    ref *= mask_np
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1), workers=-1) / (4.0 * W * H)

    bench = Precision(coeff="float32", intermediate="i8", tol=1e-5)
    deep = Precision(coeff="float32", intermediate="i8")
    plans = {p: filter_plans((H, W), p, mask=mask_np, device=dev) for p in (bench, deep)}
    x = torch.from_numpy(x_np).to(dev)
    mask = torch.from_numpy(mask_np.astype(np.float32)).to(dev)
    flat = SpecChainParams.template("flat")
    copy = SpecChainParams.template("copy")

    def chain(p):
        return fused_filter_2d(x, mask, plans[p], p)

    def spec_round_trip(p, params=flat):
        f, _ = spec_forward(x, params, p)
        return spec_inverse(f, params, precision=p)

    def launched(fn, expect):
        before = dict(int8mm.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        got = {n: int8mm.LAUNCHES[n] - before.get(n, 0) for n in REPLACES}
        got = {n: v for n, v in got.items() if v}
        if got != expect:
            raise RuntimeError(f"kernel launches {got}, expected {expect}")
        return out

    int8mm.LAUNCHES.clear()
    y = {p: launched(lambda p=p: chain(p), {f"left{n}": 2, f"right{n}": 2})
         for p, n in ((bench, 3), (deep, 4))}
    back_exact = launched(lambda: spec_round_trip(Precision()), {})
    back_i8 = launched(lambda: spec_round_trip(bench), {"left3": 2, "right3": 2})
    launches = {n: int8mm.LAUNCHES[n] for n in REPLACES}
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")

    for p, label in ((bench, "i8@1e-5"), (deep, "i8")):
        err = float(np.max(np.abs(y[p].cpu().numpy().astype(np.float64) - ref)))
        with plain_versions():
            y_plain = chain(p)
        same = torch.equal(y[p], y_plain)
        print(f"4K fused chain {label}: max abs err vs f64 {err:.3e}, "
              f"kernel == plain: {same}", flush=True)
        if not (np.isfinite(err) and err <= CHAIN_TOL and same):
            raise RuntimeError(f"4K fused chain {label} failed")
        del y_plain

    # -t flat stores (f/2 + 0.5) * 254/255 in float32, which rounds every
    # coefficient to about 2^-24 absolute; the inverse sums h*w of those
    # independent errors, so the round trip floors near
    # c * sqrt(h*w) * 2^-24 in the JAX package too (c = 2.2 at 512x512 in
    # both packages, 3.0 at 1024x1152 on the CPU).  The gate takes c = 8;
    # a bias that sums coherently (the host-scalar division true_div
    # avoids) lands 1000x above it.  -t copy skips the offset and carries
    # the <= 1e-5 transform-accuracy gate.
    err = float((back_exact - x).abs().max())
    floor = 8.0 * np.sqrt(H * W) * 2.0**-24
    print(f"spec flat round trip (hilo -> exact): max abs err {err:.3e} "
          f"(float32 floor bound {floor:.3e})", flush=True)
    if not err <= floor:
        raise RuntimeError("spec flat round trip at the default policy failed")
    err = float((launched(lambda: spec_round_trip(Precision(), copy), {}) - x).abs().max())
    print(f"spec copy round trip (hilo -> exact): max abs err {err:.3e}", flush=True)
    if not err <= CHAIN_TOL:
        raise RuntimeError("spec copy round trip at the default policy failed")
    with plain_versions():
        back_plain = spec_round_trip(bench)
    err = float((back_i8 - x).abs().max())
    same = torch.equal(back_i8, back_plain)
    print(f"spec flat round trip i8@1e-5: max abs err {err:.3e}, "
          f"kernel == plain: {same}", flush=True)
    if not (err <= floor and same):
        raise RuntimeError("spec flat round trip at i8@1e-5 failed")
    del back_exact, back_i8, back_plain

    # ---- phase 5: chain throughput, kernel vs plain, and where it goes ---
    for p, label in ((bench, "i8@1e-5"), (deep, "i8")):
        ms = cuda_ms(lambda p=p: chain(p))
        with plain_versions():
            plain_ms = cuda_ms(lambda p=p: chain(p))
        print(f"4K fused chain {label}: {H * W / ms / 1e3:.2f} MP/s kernel "
              f"({ms:.3f} ms), {H * W / plain_ms / 1e3:.2f} MP/s plain "
              f"({plain_ms:.3f} ms)", flush=True)
    _profile_chain(torch, lambda: chain(bench), "4K fused chain i8@1e-5")

    # ---- phase 6: main path 2, the motion CLI, launches counted --------
    motion_launches = _motion_phase(torch, dev, plain_versions, int8mm, block_filter,
                                     scipy.fft)

    # ---- phase 7: main path 3, the calibration of the in-kernel split ---
    calib = _calib_phase(torch, dev, mma)

    # ---- phase 8: main path 4, spec -> ispec through files --------------
    del x, mask, plans, y, x_np, ref, mask_np
    torch.cuda.empty_cache()
    # the 3-digit kernels against their plain versions at this path's shapes
    # (here, not in phase 3, so that the earlier paths run as they did)
    spec_i8 = {}
    for layout, m, k, b, r, what in SPEC_I8_SHAPES:
        spec_i8[f"{layout}3"] = dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
            check_i8mm(3, layout, m, k, b, r, what)))
    torch.cuda.empty_cache()
    spec_cli = _spec_cli_phase(torch, dev, plain_versions, int8mm, scipy.fft)

    # ---- phase 9: main path 5, the scan CLI ------------------------------
    torch.cuda.empty_cache()
    scan_cli = _scan_phase(torch, dev, plain_versions, int8mm, check_i8mm, scipy.fft)

    # ---- phase 10: main path 6, the zoom CLI -----------------------------
    torch.cuda.empty_cache()
    zoom_cli = _zoom_phase(torch, dev, plain_versions, int8mm, check_i8mm)
    zoom_launches = {n: sum(part.get(n, 0) for part in zoom_cli["launches"].values())
                     for n in REPLACES}
    print(f"scan CLI main-path launches: {json.dumps(scan_cli['launches'])}; zoom CLI "
          f"main-path launches: {json.dumps(zoom_cli['launches'])}", flush=True)
    if not (scan_cli["launches"].get("left3") and zoom_launches["left4"]
            and zoom_launches["right4"] and zoom_launches["left3"] and zoom_launches["right3"]):
        raise RuntimeError("a kernel of the scan or zoom path never launched")

    # ---- phase 11: main path 7, applybasis, genbasis and draw -------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    basis_cli = _basis_phase(torch, dev, plain_versions, int8mm, check_i8mm)
    print(f"draw CLI main-path launches: {json.dumps(basis_cli['launches'])}; phase 11 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 12: main path 8, rotate and transcode ----------------------
    t0 = time.perf_counter()
    _rotate_phase(torch, int8mm)
    print(f"phase 12 {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 13: main path 9, motion --eval, NUT/MKV and --resume-file ---
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eval_cli = _eval_phase(torch, dev, plain_versions, int8mm, block_filter, check_i8mm,
                           scipy.fft)
    print(f"motion --eval / NUT / MKV main-path launches: {json.dumps(eval_cli)}; phase 13 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 14: main path 10, the device mesh ---------------------------
    torch.cuda.empty_cache()
    mesh_path = _mesh_main(torch, dev, check_i8mm, block_filter, scipy.fft)

    # ---- phase 15: main path 11, the ffmpeg bridge, ffplay:, BMP, sixel ----
    torch.cuda.empty_cache()
    bridge = _bridge_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft)
    if not (bridge.get("left3") and bridge.get("right3") and bridge.get("block_filter")):
        raise RuntimeError(f"a kernel of the bridge path never launched: {bridge}")

    # ---- phase 16: main path 12, JPEG in and out ----------------------------
    torch.cuda.empty_cache()
    jpeg_path = _jpeg_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft)["launches"]
    if not (jpeg_path.get("left3") and jpeg_path.get("right3")):
        raise RuntimeError(f"a kernel of the JPEG path never launched: {jpeg_path}")

    # ---- phase 17: main path 13, progressive JPEG and compressed TIFF -------
    torch.cuda.empty_cache()
    codecs = _codecs_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft)
    codec_path = codecs["launches"]
    if not (codec_path.get("left3") and codec_path.get("right3")):
        raise RuntimeError(f"a kernel of the codecs path never launched: {codec_path}")

    # ---- phase 18: main path 14, GIF through the port's own codec -----------
    torch.cuda.empty_cache()
    gif_path = _gif_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft)["launches"]
    if not (gif_path.get("left3") and gif_path.get("right3")):
        raise RuntimeError(f"a kernel of the GIF path never launched: {gif_path}")

    # ---- phase 19: main path 15, TIFF layouts and sample formats, CMYK JPEG ---
    torch.cuda.empty_cache()
    cmyk_path = _tiff_cmyk_phase(torch, dev, int8mm, block_filter, check_i8mm,
                                 scipy.fft)["launches"]
    if not (cmyk_path.get("left3") and cmyk_path.get("right3")):
        raise RuntimeError(f"a kernel of the TIFF and CMYK path never launched: {cmyk_path}")

    # ---- phase 20: main path 16, JPEG-in-TIFF, YCbCr and fax TIFF ----------
    torch.cuda.empty_cache()
    more = _tiff_more_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft)
    more_path = more["launches"]
    if not (more_path.get("left3") and more_path.get("right3")):
        raise RuntimeError(f"a kernel of the JPEG-in-TIFF and fax path never launched: "
                           f"{more_path}")

    # ---- phase 21: main path 17, WebP through the port's own decoder ---------
    torch.cuda.empty_cache()
    webp_path = _webp_phase(torch, dev, int8mm, block_filter, check_i8mm,
                            scipy.fft)["launches"]
    if not (webp_path.get("left3") and webp_path.get("right3")):
        raise RuntimeError(f"a kernel of the WebP path never launched: {webp_path}")

    # ---- phase 22: main path 18, TGA, PCX, SGI, QOI, IM, ICO and DIB --------
    torch.cuda.empty_cache()
    other_path = _other_phase(torch, dev, int8mm, block_filter, check_i8mm,
                              scipy.fft)["launches"]
    if not (other_path.get("left3") and other_path.get("right3")):
        raise RuntimeError(f"a kernel of the TGA ... DIB path never launched: {other_path}")

    # ---- phase 23: main path 19, Zstandard and LZMA TIFF, old LSB-first LZW --
    torch.cuda.empty_cache()
    zstd_path = _zstd_lzma_phase(torch, dev, int8mm, block_filter, check_i8mm,
                                 scipy.fft)["launches"]
    if not (zstd_path.get("left3") and zstd_path.get("right3")):
        raise RuntimeError(f"a kernel of the Zstandard and LZMA path never launched: {zstd_path}")

    # ---- phase 24: main path 20, progressive JPEG left short, lossless JPEG --
    torch.cuda.empty_cache()
    short_path = _short_lossless_phase(torch, dev, int8mm, block_filter, check_i8mm,
                                       scipy.fft)["launches"]
    if not (short_path.get("left3") and short_path.get("right3")):
        raise RuntimeError(f"a kernel of the short and lossless JPEG path never launched: "
                           f"{short_path}")

    # ---- phase 25: main path 21, PSD and DDS read, DDS written, CUR, DCX, IM --
    torch.cuda.empty_cache()
    psd_path = _psd_dds_phase(torch, dev, int8mm, block_filter, check_i8mm,
                              scipy.fft)["launches"]
    if not (psd_path.get("left3") and psd_path.get("right3")):
        raise RuntimeError(f"a kernel of the PSD and DDS path never launched: {psd_path}")

    # ---- phase 26: main path 22, JPEG 2000 read by the port's own codec --------
    torch.cuda.empty_cache()
    j2k = _j2k_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft)
    j2k_path = j2k["launches"]
    if not (j2k_path.get("left3") and j2k_path.get("right3")):
        raise RuntimeError(f"a kernel of the JPEG 2000 path never launched: {j2k_path}")

    # ---- phase 27: main path 23, arithmetic-coded JPEG read by the port's codec --
    torch.cuda.empty_cache()
    arith_path = _arith_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft,
                              huffman_4k_s=codecs["prog_4k_decode_s"],
                              jpg_spectrum=codecs["prog_4k_spectrum"])["launches"]
    if not (arith_path.get("left3") and arith_path.get("right3")):
        raise RuntimeError(f"a kernel of the arithmetic JPEG path never launched: {arith_path}")

    # ---- phase 28: main path 24, old-style JPEG, 12-bit JPEG, ThunderScan and RLE-W TIFF --
    torch.cuda.empty_cache()
    ojpeg_path = _ojpeg_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft,
                              jpeg_tiff_4k_s=more["jpeg_4k_decode_s"])["launches"]
    if not (ojpeg_path.get("left3") and ojpeg_path.get("right3")):
        raise RuntimeError(f"a kernel of the old-style JPEG TIFF path never launched: "
                           f"{ojpeg_path}")

    # ---- phase 29: main path 25, JPEG 2000's rest (POC, SOP/EPH, styles, RGN, COC/QCC) --
    torch.cuda.empty_cache()
    j2k_more_path = _j2k_more_phase(torch, dev, int8mm, block_filter, check_i8mm, scipy.fft,
                                    plain_4k_s=j2k["decode_4k_s"])["launches"]
    if not (j2k_more_path.get("left3") and j2k_more_path.get("right3")):
        raise RuntimeError(f"a kernel of the JPEG 2000 rest path never launched: "
                           f"{j2k_more_path}")

    kernels = [{"name": f"i8mm_{n}", "route": "cuda", "source": SRC,
                "replaces": REPLACES[n],
                "launches": (launches[n] + motion_launches.get(n, 0)
                             + calib["i8mm_launches"][n] + spec_cli[n]
                             + scan_cli["launches"].get(n, 0) + zoom_launches[n]
                             + basis_cli["launches"].get(n, 0) + eval_cli.get(n, 0)
                             + mesh_path["launches"].get(n, 0) + bridge.get(n, 0)
                             + jpeg_path.get(n, 0) + codec_path.get(n, 0)
                             + gif_path.get(n, 0) + cmyk_path.get(n, 0)
                             + more_path.get(n, 0) + webp_path.get(n, 0)
                             + other_path.get(n, 0) + zstd_path.get(n, 0)
                             + short_path.get(n, 0) + psd_path.get(n, 0)
                             + j2k_path.get(n, 0) + arith_path.get(n, 0)
                             + ojpeg_path.get(n, 0) + j2k_more_path.get(n, 0)),
                "launches_by_path": {"4k_chain": launches[n],
                                     "motion": motion_launches.get(n, 0),
                                     "calibration": calib["i8mm_launches"][n],
                                     "spec_cli": spec_cli[n],
                                     "scan_cli": scan_cli["launches"].get(n, 0),
                                     "zoom_cli": zoom_launches[n],
                                     "draw_cli": basis_cli["launches"].get(n, 0),
                                     "motion_eval": eval_cli.get(n, 0),
                                     "mesh": mesh_path["launches"].get(n, 0),
                                     "bridge": bridge.get(n, 0),
                                     "jpeg": jpeg_path.get(n, 0),
                                     "codecs": codec_path.get(n, 0),
                                     "gif": gif_path.get(n, 0),
                                     "tiff_cmyk": cmyk_path.get(n, 0),
                                     "tiff_jpeg": more_path.get(n, 0),
                                     "webp": webp_path.get(n, 0),
                                     "other_formats": other_path.get(n, 0),
                                     "zstd_lzma_tiff": zstd_path.get(n, 0),
                                     "short_lossless_jpeg": short_path.get(n, 0),
                                     "psd_dds": psd_path.get(n, 0),
                                     "jpeg2000": j2k_path.get(n, 0),
                                     "arith_jpeg": arith_path.get(n, 0),
                                     "ojpeg_tiff": ojpeg_path.get(n, 0),
                                     "jpeg2000_more": j2k_more_path.get(n, 0)},
                **{key: stats[n][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms", "by_shape")}}
               for n in REPLACES]
    kernels[list(REPLACES).index("right3")].update(
        {f"motion_{key}": val for key, val in motion_i8.items()})
    for n, st in spec_i8.items():
        kernels[list(REPLACES).index(n)].update(
            {f"spec_cli_{key}": val for key, val in st.items()})
    kernels[list(REPLACES).index("left3")].update(
        {f"scan_cli_{key}": val for key, val in scan_cli["stats"].items()})
    for n, st in zoom_cli["stats"].items():
        kernels[list(REPLACES).index(n)].update(
            {f"zoom_cli_{key}": val for key, val in st.items()})
    for shape, res in basis_cli["stats"].items():     # "left3 H", "left3 W", "right3 W"
        n, axis = shape.split()
        kernels[list(REPLACES).index(n)].update(
            {f"draw_cli_{axis}_{key}": val for key, val in
             zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), res)})
    for n, st in mesh_path["shard_stats"].items():
        if n in REPLACES:
            kernels[list(REPLACES).index(n)].update(
                {f"mesh_shard_{key}": val for key, val in st.items()})
    kernels.append({"name": "block_filter", "route": "cuda", "source": BF_SRC,
                    "replaces": BF_REPLACES,
                    "launches": (motion_launches["block_filter"] + eval_cli["block_filter"]
                                 + mesh_path["launches"].get("block_filter", 0)
                                 + bridge.get("block_filter", 0)
                                 + jpeg_path.get("block_filter", 0)
                                 + codec_path.get("block_filter", 0)
                                 + gif_path.get("block_filter", 0)
                                 + cmyk_path.get("block_filter", 0)
                                 + more_path.get("block_filter", 0)
                                 + webp_path.get("block_filter", 0)
                                 + other_path.get("block_filter", 0)
                                 + zstd_path.get("block_filter", 0)
                                 + short_path.get("block_filter", 0)
                                 + psd_path.get("block_filter", 0)
                                 + j2k_path.get("block_filter", 0)
                                 + arith_path.get("block_filter", 0)
                                 + ojpeg_path.get("block_filter", 0)
                                 + j2k_more_path.get("block_filter", 0)),
                    "launches_by_path": {"motion": motion_launches["block_filter"],
                                         "motion_eval": eval_cli["block_filter"],
                                         "mesh": mesh_path["launches"].get("block_filter", 0),
                                         "bridge": bridge.get("block_filter", 0),
                                         "jpeg": jpeg_path.get("block_filter", 0),
                                         "codecs": codec_path.get("block_filter", 0),
                                         "gif": gif_path.get("block_filter", 0),
                                         "tiff_cmyk": cmyk_path.get("block_filter", 0),
                                         "tiff_jpeg": more_path.get("block_filter", 0),
                                         "webp": webp_path.get("block_filter", 0),
                                         "other_formats": other_path.get("block_filter", 0),
                                         "zstd_lzma_tiff": zstd_path.get("block_filter", 0),
                                         "short_lossless_jpeg":
                                             short_path.get("block_filter", 0),
                                         "psd_dds": psd_path.get("block_filter", 0),
                                         "jpeg2000": j2k_path.get("block_filter", 0),
                                         "arith_jpeg": arith_path.get("block_filter", 0),
                                         "ojpeg_tiff": ojpeg_path.get("block_filter", 0),
                                         "jpeg2000_more": j2k_more_path.get("block_filter", 0)},
                    **bf_stats,
                    **{f"mesh_shard_{key}": val for key, val in
                       mesh_path["shard_stats"]["block_filter"].items()}})
    kernels += [{"name": f"i8split_{n}", "route": "cuda", "source": I8S_SRC,
                 "replaces": I8S_REPLACES[n], "launches": calib["launches"][n],
                 "launches_by_path": {"calibration": calib["launches"][n]},
                 **calib["stats"][n]} for n in I8S_REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
