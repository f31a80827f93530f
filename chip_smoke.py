"""Chip smoke for the PyTorch/CUDA port (yolov5m_tpu_torch) on one GPU.

Run from the repo root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA NMS kernel (greedy_keep) from csrc/nms.cu
     and print nvcc's -Xptxas -v report (registers, shared memory, spills);
  3. kernel against plain: the keep mask must equal the plain fixpoint's
     exactly over K in {128, 512, 1024, 2048}, bs in {1, 128} and the cases
     dense clusters, score ties, many classes, all-invalid, the
     alternating chain, K not a multiple of 32, a valid mask with holes,
     and boxes on a half-pixel grid whose IoUs lie at the threshold, swept
     over five thresholds (54 cases); the kernel's time per K on dense
     clusters at bs 128, and at K 2048 on many classes and on the chain;
  4. main path at full width: flagship YOLOv5m (first_out 48, nc 80, BN
     folded, bf16, channels_last) on 128 structured 640x640 uint8 frames,
     normalize -> model -> fused_detect (K 512); the kernel must have been
     launched, the plain backend must give identical results, and
     detections per image must reach 1.0; median images/s; the kernel
     timed and checked on the main path's own NMS input and on the
     evaluator's (the same predictions gated at conf 0.01, K 1024);
  5. server: the port's DetectionServer (bs 16, conf 0.25) answers 16
     non-square PPM frames from two pipelining clients, in order, and
     launches the kernel;
  6. training and evaluation at full width (first_out 48, depth 0.67, nc
     80) from the flagship weights:
     a. the Trainer at bs 16 on synthetic batches of 512/576/640,
        accumulate 4: bf16 loss parts against f32 ones, 4 warmup and 16
        timed micro-batches (median images/s over the 4 updates), every
        loss and grad_norm finite, each stage timed alone, peak memory;
     b. the Evaluator on 4 fixed val batches of 16 at 640, flagship and
        EMA weights: one kernel launch per batch, the same dict with the
        plain NMS, flagship map50 >= 0.5, images/s and the host matcher's
        share; the kernel timed on the eval loop's own NMS input;
     c. the train CLI in a temporary directory: one epoch from the
        flagship npz with the prediction images (the CLI's default), then
        --resume for one more with --nosaveimgs: both checkpoints, two
        eval rows, SAVED_IMAGES/model_1/EPOCH_1/image_{0..4}.png each
        decoded by the port's PNG decoder, 4 kernel launches for the
        evaluations and 1 for the images' NMS;
  7. disk data and detect at full width, from the flagship weights:
     a. a COCO-format disk dataset of PPM scenes (64 train, 40 val) at
        640x480 and 960x540 in a temporary directory;
     b. the Trainer on get_loaders (4 workers, multi-scale) at bs 16,
        accumulate 4, device mosaic 0.5, device HSV, color jitter and
        flips: images/s, the loader's wait and build ms per batch, the
        device augment's ms; then one update without remat, with remat
        "c3" and with "all" (loss parts within the bf16 check), peak
        memory and images/s each;
     c. one step at bs 96, 640, without and with remat: peak memory and
        images/s;
     d. the Evaluator on the disk val loader: one kernel launch per batch,
        the same dict with the plain NMS, flagship map50 >= 0.5, GT boxes
        back in source pixels (orig_hw), images/s, the host's share;
     e. cli.detect --all over the val PPM directory at bs 16: ceil(n/16)
        launches, the same results with the plain NMS, >= 1.0 detections
        an image, images/s with host decode;
     f. the train CLI on the disk dataset with device mosaic, device
        augment, HSV and autoanchor, then --resume: both checkpoints, two
        eval rows, anchors.json exactly when the refit fires;
     g. the dataset's scenes written as PNG (this file's writer: stdlib
        zlib, rows cycling through the five filter types), read by the
        port's PNG decoder: the Trainer on get_loaders at bs 16,
        accumulate 4, with the host's default TrainAugment (rotate, blur,
        CLAHE, posterize, channel shuffle through the port's C ops), host
        mosaic 0.5 and host HSV: loss parts finite, images/s against 7b's,
        a batch's build ms on one thread and on four against 7b's, and
        each C op (rotate, blur, CLAHE, HSV, the mosaic's downscale)
        counted at least once in the run; the Evaluator on the PNG val
        loader (one kernel launch a batch, 7d's metrics exactly) and
        cli.detect --all over the 40 PNG val scenes (ceil(n/16) launches,
        the detections of 7e over their PPM twins);
     h. cli.detect --all --save_pred over the 40 val PPM scenes (no
        matplotlib on the card: the port's renderer, csrc/plot.cc): 40
        *_pred.png files that the port's PNG decoder reads, each equal,
        pixel for pixel, to the renderer called directly on detect's own
        results; ceil(40/16) = 3 kernel launches; images/s with and
        without --save_pred in the same call;
  8. data parallelism on one card, full width, flagship weights:
     a. two ranks spawned on cuda:0 over gloo (f32, TF32 off, sync-BN,
        global bs 16 at 640, accumulate 2, two updates) against one
        process on the global batch: loss rtol 1e-4, grad_norm rtol 1e-3,
        parameters within 2.1e-3 with under 1% beyond 1e-4, BN buffers
        within 1e-4; then two bf16 local-BN updates leave the ranks'
        parameters, buffers and EMA bitwise equal;
     b. NCCL at world size 1: the DP trainer (bf16, bs 16, accumulate 4)
        exactly equal to the plain Trainer after one update, and both
        rates in the same call; the train CLI's rank path at world size 1
        (rank 0 evaluates through the kernel, one launch a val batch);
     c. make_dp_infer_fn over ["cuda:0", "cuda:0"] at bs 256: each 128
        shard exactly equal to the one-device pipeline, 2 launches a
        batch, images/s; DetectionServer(dp_devices=...) answers the
        phase-5 frames as the one-device server does;
     d. the train CLI with --dp 2 on one card exits before any work;
  9. host preprocessing, JPEG, the compact gate, export and a trace, full
     width, flagship weights:
     a. the native library (csrc/preprocess.cc, the port's JPEG and PNG
        decoders csrc/jpeg_decode.cc and png_decode.cc and the host
        augmentation's csrc/augment.cc, built with g++ in phase 2, no
        libjpeg): its compile line and build seconds; its resize and
        letterbox within 1 code of the numpy versions at phase 7's scene
        sizes; one 960x540 -> 640 letterbox timed both ways; phase 7b's
        batch build on one thread and on four, with the C resize and with
        numpy;
     b. the JPEG decoder: every file of the committed corpus
        (tests/fixtures/torch_jpeg_corpus/) decodes to the sha256 that
        the JAX package's libjpeg decode gave where the corpus was made,
        gives None exactly where it gave None, and reads the same header
        size, arithmetic-coded and smoothed progressive files among them;
        the scene's two arithmetic twins (its coefficients recoded,
        sequential and progressive) decode to the scene's own digest; the
        committed JPEG fixtures decode within a mean of 3 codes of their
        sources; one decode of a 640x480 and of a 960x540 fixture timed
        on one thread, the six decoded at once on four; one decode of the
        640x480 scene, of its arithmetic twins and of its unrefined
        recodings (the smoothed path), Huffman and arithmetic, timed on
        one thread; cli.detect --all over the scene and its arithmetic
        twins (the same detections, the kernel launched);
        cli.detect --all over the fixtures at bs 16 (ceil(n/16)
        launches, >= 1.0 detections an image, the same results with the
        plain NMS) and its images/s over 40 JPEG files against 7e's rate
        over the PPM directory; the DetectionServer answers the fixtures
        as bytes with detect's results and launches the kernel;
     c. fused_detect(gate="compact") on phase 4's 128 frames (K 512):
        bitwise the sort gate while every image's survivors fit in K, one
        launch a batch; gate + top-K + decode ms and images/s of both
        gates; above capacity (conf 1e-4: at 0.01 the flagship's images fit
        in K) the compact gate equals its CPU run on the same logits;
     d. gate_density: survivors and detections an image, the detections
        phase 4's;
     e. export: the flagship's ONNX structure; its torch.export program
        (f32, bs 1, 640) saved, loaded and run within 1e-4 of eager, and
        with postprocess giving eager decode + plain NMS's detections;
        phase 6c's checkpoint stripped and loaded by detect, its
        parameter count the JAX package's;
     f. a torch.profiler trace of one main-path batch at bs 128: the five
        device operations that took the most time, and the device's idle
        share over the traced window;
     g. the host augmentation's C ops (csrc/augment.cc) and the PNG
        decoder (csrc/png_decode.cc, inflated by Python's zlib): every op
        on seeded inputs (tests/torch_cv_ops_cases.py) gives the sha256
        of cv2's output committed in tests/fixtures/torch_cv_ops_digests
        .json; every file of the PNG corpus (tests/fixtures/
        torch_png_corpus/) decodes to Pillow's digest and header size, and
        is refused where Pillow refuses it; one 640x640 call of rotate,
        blur k 7, CLAHE, HSV and the downscale, and one 640x480 PNG
        decode, timed on one thread;
     h. the prediction images: every case of tests/torch_plot_cases.py
        (plot_image at 640x480, 960x540, 480x640 and 64x64, boxes past
        every edge, the COCO and FLIR lists; save_prediction_images)
        rendered by the port and its decoded RGBA held to the sha256 of
        the JAX package's (matplotlib's) image committed in
        tests/fixtures/torch_plot_digests.json; one plot_image and one
        save_prediction_images at 640x480 timed (median of 5);
     i. the decodes the JAX package leaves to Pillow 12.1.0, in the port's
        own C (no PIL on the card): every file of tests/fixtures/
        torch_pillow_corpus/ (CMYK, YCCK and lossless JPEG, libjpeg-turbo
        3.1.3's smoothing and refusal of cut files, BMP, GIF) gives the
        sha256 of both JAX routes (the loader's and the server's
        _decode_image; detect --img's Image.open) and Pillow's size, and
        is refused where they fail; one decode of each 640x480 scene
        timed on one thread (the unrefined one on both routes);
        cli.detect --all over the CMYK, YCCK, lossless, BMP and GIF scenes
        (all named .jpg), detect --img on the unrefined scene and the
        server on the CMYK, YCCK, BMP and GIF scenes each give the
        detections of the same run on the decoded pixels written as PPM,
        and launch the kernel (ceil(5/16) = 1 for --all, 1 for --img);
     j. WebP as Pillow 12.1.0 decodes it over libwebp 1.6.0, in the port's
        own C (csrc/webp_decode.cc; no PIL or libwebp on the card): every
        file of tests/fixtures/torch_webp_corpus/ (lossy with each loop
        filter, sharpness and partition count, lossless with palettes,
        ALPH raw and coded under each filter, an animation's first frame,
        refusals) gives the sha256 of both JAX routes and Pillow's size,
        and is refused where they fail; one decode of the 640x480 lossy,
        lossless and alpha scenes timed on one thread; cli.detect --all
        over the three scenes named .jpg, detect --img on the lossy .webp
        and the server on all three each give the detections of the same
        run on the decoded pixels written as PPM, and launch the kernel
        (1 for --all, 1 for --img); detect's images/s over WebP files
        against the same pixels as PPM files, in turns;
     k. PNM as Pillow 12.1.0's PpmImagePlugin reads it, in the port's own
        code (data/pnm.py, csrc/pnm_decode.cc; no PIL on the card): every
        file of tests/fixtures/torch_pnm_corpus/ (P1-P6 at every maxval
        class, Pf, Pillow's extensions, header and plain-data rules,
        refusals) and the six 640x480 scenes made from the seed (P6 at 255
        and at maxval 1000, a 16-bit P5, plain P3 and P1, Pf) give the
        sha256 of both JAX routes and Pillow's size, and are refused where
        they fail; one decode of each scene timed on one thread;
        cli.detect --all over the six scenes, detect --img on the plain P3
        and the server on all six each give the detections of the same run
        on P6 twins of the decoded pixels, and launch the kernel (1 for
        --all, 1 for --img); detect's images/s over 24 plain P3 files
        against their P6 twins, in turns;
     l. TIFF as Pillow 12.1.0's TiffImagePlugin reads it over libtiff
        4.7.1, in the port's own code (data/tiff.py, csrc/tiff_decode.cc;
        PIL blocked for the corpus, whether or not the machine has it):
        every file of
        tests/fixtures/torch_tiff_corpus/ (uncompressed, PackBits, LZW old
        and new, deflate; strips, tiles, planes; predictors 2 and 3;
        BigTIFF, both byte orders, Orientation 1-8, Pillow's and libtiff's
        refusals) gives the sha256 of every JAX route (the server's bytes,
        the loader's and detect --img's path) and Pillow's size, the files
        whose tags the port leaves to PIL (CIELab, fax, ThunderScan, log)
        refused with their size read; the seven 640x480 scenes made
        from the seed (uncompressed, PackBits, LZW, LZW with predictor 2,
        deflate tiles with predictor 2, planar, 16-bit grey) give their
        digests; one decode of each timed on one thread; cli.detect --all
        over the seven named .jpg, detect --img on a .tif under
        Orientation 6 and the server on all seven each give the detections
        of the same run on PPM twins of the decoded pixels, and launch the
        kernel (1 for --all, 1 for --img); detect's images/s over 24 LZW
        files against their PPM twins, in turns;
     m. YCbCr and JPEG TIFF as Pillow reads them over libtiff's JPEG
        codec (libjpeg-turbo 3.1.3) and TIFFRGBAImage, in the port's own
        code (data/tiff.py, csrc/jpeg_decode.cc mode 2,
        csrc/tiff_decode.cc; PIL blocked for the corpus): every file of
        tests/fixtures/torch_tiff_jpeg_corpus/ (JPEG under every
        photometric, strips, tiles, planes, JPEGTables on and off, cut
        streams, tags against the streams; packed YCbCr at every
        subsampling under LZW, deflate, PackBits and none) gives the
        sha256 of every JAX route and Pillow's size; the five 640x480
        scenes made from the seed (YCbCr 2x2 JPEG with tables, RGB JPEG,
        grey JPEG, YCbCr 2x2 LZW, uncompressed YCbCr) give their digests;
        one decode of each timed on one thread; cli.detect --all over the
        five named .jpg, detect --img on the YCbCr JPEG scene under
        Orientation 6 and the server on all five each give the detections
        of the same run on PPM twins, and launch the kernel (1 for --all,
        1 for --img); detect's images/s over 24 YCbCr JPEG files against
        their PPM twins, in turns;
     n. ZSTD and LZMA TIFF as Pillow reads them over libtiff's ZSTDDecode
        (libzstd 1.5.7) and LZMADecode (liblzma 5.8.2), in the port's own
        code (data/tiff.py, csrc/zstd_decode.cc, csrc/xz_decode.cc; PIL
        blocked for the corpus): every file of
        tests/fixtures/torch_tiff_zstd_lzma_corpus/ (libtiff's and
        Pillow's files, frames and streams cut, flipped, doubled, behind
        skippable frames, at every filter chain; WebP in TIFF refused)
        gives the sha256 of every JAX route and Pillow's size, none left
        to PIL; one decode of each committed 640x480 scene (ZSTD, ZSTD
        with predictor 2, LZMA preset 6 with predictor 2, YCbCr 2x2 under
        ZSTD) timed on one thread; cli.detect --all over the four named
        .jpg, detect --img on the ZSTD scene under Orientation 6 and the
        server on all
        four each give the detections of the same run on PPM twins, and
        launch the kernel (1 for --all, 1 for --img); detect's images/s
        over 24 ZSTD files against their PPM twins, in turns;
     o. 12-bit JPEG TIFF and old-style JPEG TIFF as Pillow reads them over
        libtiff's JPEG codec (its 12-bit branch over libjpeg-turbo
        3.1.3's jpeg12 API) and its old-style JPEG codec (tif_ojpeg.c,
        then TIFFRGBAImage), in the port's own code (data/tiff.py,
        csrc/jpeg_decode.cc; PIL blocked for the corpus): every file of
        tests/fixtures/torch_tiff_ojpeg_corpus/ (12-bit grey in strips and
        tiles, progressive, arithmetic, lossless; old-style JPEG through
        JPEGInterchangeFormat and from tables at every subsampling, grey,
        tiled, planar, strips missing or cut; the refusals of both) gives
        the sha256 of every JAX route and Pillow's size, none left to PIL;
        one decode of each committed 640x480 scene (12-bit grey JPEG,
        old-style JPEG 2x2 through JPEGInterchangeFormat, old-style JPEG
        from tables) timed on one thread; cli.detect --all over the three
        named .jpg, detect --img on the old-style scene under Orientation
        6 and the server on all three each give the detections of the
        same run on PPM twins, and launch the kernel (1 for --all, 1 for
        --img); detect's images/s over 24 old-style JPEG files against
        their PPM twins, in turns;
     p. legacy zstd frames in ZSTD TIFF (v0.5, v0.6, v0.7: libzstd
        1.5.7's legacy streaming decoders under ZSTDDecode) and CIELab
        TIFF (Pillow's LAB mode and its LittleCMS transform to sRGB), in
        the port's own code (csrc/zstd_decode.cc, data/tiff.py,
        data/convert.py, csrc/lab_convert.cc), PIL blocked for the whole
        phase: every file of tests/fixtures/torch_tiff_zstd_legacy_corpus/
        and tests/fixtures/torch_tiff_lab_corpus/ gives the sha256 of
        every JAX route and Pillow's size, none left to PIL; the port's
        Lab to RGB of all 2^24 LAB pixels gives the committed sha256 of
        Pillow's (timed); one decode of each 640x480 scene (v0.5 and v0.7
        ZSTD of compressed blocks, CIELab uncompressed and LZW) timed on
        one thread; for each corpus, cli.detect --all over its scenes
        named .jpg, detect --img on its scene under Orientation 6 and the
        server on its scenes each give the detections of the same run on
        PPM twins, and launch the kernel (1 for --all, 1 for --img);
        detect's images/s over 24 v0.7 ZSTD files and 24 CIELab LZW files
        against their PPM twins, in turns;
     q. CCITT fax TIFF (RLE, RLEW, Group 3 1D and 2D, Group 4:
        libtiff's tif_fax3.c), ThunderScan TIFF (tif_thunder.c) and
        SGILog TIFF (refused, as Pillow refuses it) in the port's own code
        (csrc/fax_decode.cc, csrc/tiff_decode.cc, data/tiff.py), PIL
        blocked: in two parts, 9q.fax and 9q.thunder, each over its files
        of tests/fixtures/torch_tiff_fax_corpus/: every file gives the
        sha256 of every JAX route and Pillow's size, none left to PIL; one
        decode of each 640x480 scene (Group 4, Group 3 2D with fill bits
        under FillOrder 2, RLE; 4-bit ThunderScan) timed on one thread;
        cli.detect --all over the scenes named .jpg, detect --img on the
        Group 4 (or ThunderScan) scene under Orientation 6 and the server
        on the scenes each give the detections of the same run on PPM
        twins, and launch the kernel (1 for --all, 1 for --img); detect's
        images/s over 24 Group 4 files and 24 ThunderScan files against
        their PPM twins, in turns;
     r. JPEG 2000 (J2K codestreams and JP2 files) as Pillow reads it over
        OpenJPEG 2.5.4, in the port's own code (data/jpeg2k.py,
        csrc/j2k_decode.cc), PIL blocked for the phase: every file of
        tests/fixtures/torch_jpeg2k_corpus/ gives the sha256 of every JAX
        route and Pillow's size, and only the files whose markers name
        HTJ2K code-blocks or Part 2's MCT are left to PIL (refused here,
        their sizes read); one decode of each committed 640x480 scene
        (lossless, irreversible with the ICT, irreversible in 256x256
        tiles, 12-bit grey) timed on one thread; cli.detect --all over
        the four scenes named .jpg, detect --img on the ICT scene and the
        server on all four each give the detections of the same run on
        PPM twins, and launch the kernel (1 for --all, 1 for --img);
        detect's images/s over 24 JP2 files of the ICT scene against
        their PPM twins, in turns; then, outside the block and where PIL
        is importable, one decode of each scene by the port and by
        Pillow (the JAX routes' decoder), in turns on one thread, and
        whether the two give equal pixels there;
     s. DIB, ICO, CUR, PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM
        as Pillow's plugins read them, routed in Pillow's open order, in
        the port's own code (data/formats.py, data/raster.py,
        csrc/raster_decode.cc), PIL blocked for the phase: every file of
        tests/fixtures/torch_raster_corpus/ gives the sha256 of every JAX
        route and Pillow's size, and only the files whose headers IMT or
        PCD (plugins the port does not read) open are left to PIL; the
        640x480 scene made from the seed as TGA RLE, PCX RGB, SGI RLE,
        QOI, IM, SPIDER and XBM and its 256x256 crop as ICO, each at its
        digests and one decode timed on one thread; cli.detect --all over
        the eight named .jpg, detect --img on the TGA and the server on
        all eight each give the detections of the same run on PPM twins,
        and launch the kernel (1 for --all, 1 for --img); detect's
        images/s over 24 TGA RLE files against their PPM twins, in turns;
        then, outside the block, Pillow's decode of each scene beside the
        port's, in turns (report-only);
     t. DDS, BLP and FTEX as Pillow's plugins read them, in the port's
        own code (data/bcn.py, csrc/bcn_decode.cc: Pillow's "bcn" decoder
        for BC1-BC7, DDS's dds_rgb, BLP2's own DXT decoders; BLP1's JPEG
        through csrc/jpeg_decode.cc), PIL blocked for the phase: every
        file of tests/fixtures/torch_bcn_corpus/ gives the sha256 of every
        JAX route and Pillow's size, none left to PIL; the 640x480 scene
        made from the seed as DDS DXT1, BC7, BC6H and RGB565, BLP2 DXT5,
        BLP1 palette and FTEX DXT1, each at its digests and one decode
        timed on one thread; cli.detect --all over the seven named .jpg,
        detect --img on the BC7 DDS and the server on all seven each give
        the detections of the same run on PPM twins, and launch the
        kernel (1 for --all, 1 for --img); detect's images/s over 24 BC7
        DDS files against their PPM twins, in turns; then, outside the
        block, Pillow's decode of each scene beside the port's, in turns
        (report-only);
  10. int8 PTQ and the s2d stem, full width, flagship weights:
     a. the flagship with the space-to-depth stem (bf16, channels_last)
        against phase 4's 6x6 model: the stem alone timed both ways;
        logits within relative RMS 0.02 in bf16 on phase 4's 128 frames
        and within 1e-4 of the largest logit in f32 (TF32 off) on 8;
        main-path images/s of both, interleaved, and the s2d path's NMS
        launches;
     b. the flagship quantized (chain and per block) on 8 of phase 4's
        frames; every distinct int8 conv of both on one frame (stem with
        K padded to 112, 1x1, 3x3 s1 and s2, split parts): torch._int_mm's
        int32 accumulators on the card equal the float64 conv on the CPU;
        which operand layouts _int_mm takes; the f32 int8 chain on one
        frame within relative RMS 0.01 of its CPU run;
     c. 128 frames through normalize -> int8 model -> fused_detect (K
        512): one launch a batch, the same detections with the plain NMS,
        logits within relative RMS 0.1 of the bf16 model (JAX's own int8
        flagship is 0.038-0.048 from its float model at 640), median IoU
        > 0.85 of bf16's top detections; images/s of bf16, int8 chain and
        int8 per block in turns, and each one's peak GiB; one int8 forward
        split into its conv_int8 (gather, _int_mm) and float-side device
        ms; a profiler trace of one int8 chain batch;
     d. cli.detect --all --int8 over phase 7's 40 val images at bs 16:
        ceil(n/16) launches, the calibration line, a result for each image,
        the same results with the plain NMS, median IoU > 0.85 against
        7e's bf16 detections;
  11. spatial, tensor and pipeline parallelism on one card, full width,
     flagship weights, every grid cell cuda:0 (parity in f32 with TF32
     off, rates in bf16):
     a. make_sp_infer_fn over 1x2 and 1x4 (bs 1 and 16) and 2x2 (bs 16)
        (data, spatial) grids: valid masks equal and detections within
        1e-4 of the one-device pipeline, one launch a batch, the same
        detections with the plain NMS; bs-1 ms a batch and bs-16 images/s
        against one device; peak GiB;
     b. make_sp_train_step at bs 4 on 1x2 and 2x2 against the plain
        Trainer on the global batch: loss within 1e-5 relative, grad_norm
        1e-3, parameters and EMA within 2.1e-3, BN buffers 1e-4;
     c. make_tp_infer_fn at bs 16 on 1x2 and 2x2 (data, model) grids with
        11a's checks and rates; make_tp_train_step with 11b's bounds; the
        leaves the 2-way split shards;
     d. make_pp_infer_fn (2 stages, 4 micro-batches of 4): 4 launches a
        call, detections within 1e-5 of the one-device pipeline on each
        micro-batch; make_pp_train_step (2 and 4 stages) against the
        Trainer at accumulate 4 on the same micro-batches within 1e-5
        (deterministic cuDNN); DPxPP 2x2 finite; bf16 images/s of PP
        inference, PP and DPxPP training against one device and the
        plain Trainer; peak GiB;
     e. DetectionServer(tp_devices=[["cuda:0", "cuda:0"]]) answers the
        phase-5 frames as the one-device server does in f32 (the same
        classes, confidences within 2e-5, boxes within 0.02 px) and
        launches the kernel; in bf16 the replies are compared and
        reported;
     f. the train CLI with --sp 2 on one card exits before any work;
     g. make_sp_infer_fn at heights whose rows split unevenly: 576x640
        over 1x4 (P5 5/5/5/3) and 640x640 over 1x8 (P5 3x6, 2, 0: an
        empty shard) at bs 1 and 16, 544x640 over 2x4 at bs 16, with
        11a's checks against the one-device pipeline at that height, bs-1
        ms and bs-16 images/s against one device; make_sp_train_step at
        576 over 1x4 with 11b's bounds;
     h. the flagship quantized in both schemes (calibrated as in 10b) on
        SP 1x2, 1x4, SP 576 over 1x4, TP 1x2 and 2x2 at bs 16: valid masks
        equal and detections within 1e-4 of the one-device int8 pipeline
        (the largest difference printed, and whether it is 0), one launch
        a batch, the same detections with the plain NMS; each grid's
        images/s against one-device int8 and bf16; the TP server with the
        int8 chain model answering the phase-5 frames as the one-device
        int8 server does (11e's f32 bounds);
  12. the kernels line, then the last line {"ok": true, "device": ...}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# the CUDA NMS kernel's TPU counterpart (the function reaching pallas_call)
REPLACES = "yolov5m_tpu/ops/pallas/nms_kernel.py:55"
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# float32 non-tensor-core FLOP/s. nms.cu is built with --fmad=false and
# does no FMA, while 67 TFLOP/s counts an FMA as two operations, so the
# f32 rate, and with it the bound by operations, is optimistic.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per IoU decision in nms.cu: 2x(min, max, sub, max) for
# the overlap, 1 mul, 3 add/sub for the union, 1 div, 2 compares
OPS_PER_PAIR = 15
# bytes the function must move: valid read and keep written for every
# row; box and class read only for valid rows (an invalid row is never
# kept and never suppresses, so its box and class cannot change keep)
BYTES_PER_ROW = 1 + 1
BYTES_PER_VALID_ROW = 16 + 4
# the grid case's IoU thresholds, and how near t an IoU counts as "at" it
GRID_THRESHOLDS = (0.25, 1 / 3, 0.45, 0.5, 0.6)
NEAR_T = 1e-6
# YOLOv5(first_out=48, nc=80)'s trainable parameters, as the JAX
# package's count_parameters gives them (tests/test_torch_export.py holds
# this number against it)
JAX_FLAGSHIP_PARAMETERS = 21190557
# bf16 activations against f32 ones on the same weights and batch: each
# loss part within 5% (bf16 keeps 8 bits of mantissa, about 0.4% a value,
# through some 60 layers)
BF16_LOSS_RTOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events each."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stage_ms(fn, reps: int = 5, prepare=lambda: None) -> list:
    """[card ms, host ms] medians over reps of fn(prepare()), after a sync:
    CUDA events around the call, and the host clock around issuing it.
    Where the two are close, the card waited for the host."""
    card, host = [], []
    for _ in range(reps):
        arg = prepare()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(arg)
        end.record()
        host.append(1e3 * (time.perf_counter() - t0))
        end.synchronize()
        card.append(start.elapsed_time(end))
    return [statistics.median(card), statistics.median(host)]


def device_ms(fn, reps: int = 100, rounds: int = 5) -> float:
    """Median over rounds of the device milliseconds per call of fn(), with
    reps calls queued back to back behind a spinning kernel (about 50 ms,
    far longer than the host takes to enqueue them), so that the host's
    per-call overhead does not reach the device's timeline."""
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def keep_bound_ms(valid: torch.Tensor, keep: torch.Tensor) -> tuple:
    """(ms, "bytes" | "operations") of the fused keep-mask function on these
    inputs: the larger of the bytes it must move (BYTES_PER_ROW a row,
    BYTES_PER_VALID_ROW more a valid row) over the HBM rate and, over the
    f32 rate, OPS_PER_PAIR for each IoU decision it needs: a kept row j is
    checked against every earlier kept row, and a removed valid row needs
    one decision, by the kept row that removes it."""
    bs, k = valid.shape
    kept = keep.int()
    kept_before = kept.cumsum(1) - kept
    decisions = float((kept_before * kept).sum() + (valid & ~keep).sum())
    n_bytes = bs * k * BYTES_PER_ROW + float(valid.sum()) * BYTES_PER_VALID_ROW
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = decisions * OPS_PER_PAIR / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(nms, nms_kernel, boxes, cls, valid, iou_t, plain_reps: int):
    """The kernel against the plain fixpoint on one input: mismatches,
    device ms, ms per call (events around each call, host included, as
    the stage table and the earlier pair were timed), plain ms, bound."""
    got = nms_kernel.greedy_keep_cuda(boxes, cls, valid, iou_t)
    want = nms.suppress(boxes, cls, valid, iou_t, backend="torch")
    err = (got.int() - want.int()).abs()
    bound = keep_bound_ms(valid, want)
    return {"mismatches": int(err.sum()), "max_abs_err": float(err.max()),
            "ms": device_ms(lambda: nms_kernel.greedy_keep_cuda(
                boxes, cls, valid, iou_t)),
            "call_ms": cuda_ms(lambda: nms_kernel.greedy_keep_cuda(
                boxes, cls, valid, iou_t), 50),
            "plain_ms": cuda_ms(lambda: nms.suppress(
                boxes, cls, valid, iou_t, backend="torch"), plain_reps),
            "bound_ms": bound[0], "bound_by": bound[1],
            "valid_per_image": float(valid.sum(1).float().mean()),
            "kept_per_image": float(want.sum(1).float().mean())}


# -- phase 3: kernel against plain ------------------------------------------

def nms_case_rows(case: str, bs: int, k: int, seed: int) -> tuple:
    """(rows (bs, k, 6) [class, conf, cx, cy, w, h], conf gate, iou t);
    "holes" gives the dense rows (its valid mask is drawn by holes())."""
    rng = np.random.default_rng(seed)
    if case == "chain":
        # box i overlaps only i-1 and i+1 (IoU .43), scores descending:
        # greedy keeps the evens, and the fixpoint needs ~k/2 rounds
        i = np.arange(k, dtype=np.float32)
        one = np.stack([np.zeros(k), 1.0 - i / (2 * k), 20.0 * i + 25.0,
                        np.full(k, 100.0), np.full(k, 50.0),
                        np.full(k, 50.0)], -1)
        return np.repeat(one[None], bs, 0).astype(np.float32), 0.01, 0.3
    if case == "grid":
        # integer centres and sizes: corners on a half-pixel grid, so many
        # pairs have IoU within a few ulps of t (decisions at the edge)
        cxy = rng.integers(0, 9, (bs, k, 2))
        wh = rng.integers(1, 7, (bs, k, 2))
        cls = rng.integers(0, 2, (bs, k))
        conf = rng.uniform(0, 1, (bs, k))
        rows = np.concatenate([cls[..., None], conf[..., None], cxy, wh], -1)
        return rows.astype(np.float32), 0.25, 0.5
    nc = {"dense": 2, "holes": 2, "ties": 3, "many": 80, "invalid": 5}[case]
    centers = rng.uniform(100, 540, (bs, 12, 2))
    pick = rng.integers(0, 12, (bs, k))
    cxy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 12, (bs, k, 2))
    wh = rng.uniform(40, 120, (bs, k, 2))
    cls = rng.integers(0, nc, (bs, k))
    conf = rng.uniform(0, 1, (bs, k))
    if case == "ties":
        conf = rng.integers(1, 5, (bs, k)) / 5.0     # many exact ties
    if case == "invalid":
        conf = np.zeros((bs, k))
    rows = np.concatenate([cls[..., None], conf[..., None], cxy, wh], -1)
    return rows.astype(np.float32), 0.25, 0.5


def holes(valid: torch.Tensor, seed: int) -> torch.Tensor:
    """A random valid mask with holes (not a prefix), same shape and device."""
    mask = np.random.default_rng(seed).random(tuple(valid.shape)) < 0.6
    return torch.from_numpy(mask).to(valid.device)


def near_threshold_pairs(boxes, cls, valid, iou_t: float) -> int:
    """Pairs i < j of valid same-class rows whose IoU lies within NEAR_T
    of the threshold: how many decisions the grid case puts at the edge."""
    from yolov5m_tpu_torch.ops.boxes import pairwise_iou_xyxy
    near = (pairwise_iou_xyxy(boxes, boxes) - iou_t).abs() <= NEAR_T
    near &= cls[:, :, None] == cls[:, None, :]
    near &= valid[:, :, None] & valid[:, None, :]
    return int(near.triu(1).sum())


def kernel_vs_plain(nms, nms_kernel) -> list:
    cases = [(case, k, bs, None) for k in (128, 512, 1024, 2048)
             for bs in (1, 128)
             for case in ("dense", "ties", "many", "invalid", "chain")]
    cases += [("dense", k, bs, None) for k in (1, 33, 500, 2047)
              for bs in (1, 128)]
    cases += [("holes", 2047, 128, None)]
    cases += [("grid", 2048, 128, t) for t in GRID_THRESHOLDS]
    timings = []
    for n, (case, k, bs, grid_t) in enumerate(cases):
        rows, conf_t, iou_t = nms_case_rows(case, bs, k, seed=n)
        iou_t = iou_t if grid_t is None else grid_t
        rows = torch.from_numpy(rows).cuda()
        boxes, cls, _, valid = nms._prepare(rows, conf_t, k)
        boxes, cls, valid = (t.contiguous() for t in (boxes, cls, valid))
        if case == "holes":
            valid = holes(valid, n)
        got = nms.suppress(boxes, cls, valid, iou_t, backend="cuda")
        want = nms.suppress(boxes, cls, valid, iou_t, backend="torch")
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        near = (f" pairs within {NEAR_T} of t="
                f"{near_threshold_pairs(boxes, cls, valid, iou_t)}"
                if case == "grid" else "")
        log(f"kernel-vs-plain case={case} K={k} bs={bs} t={iou_t:.4f} "
            f"valid={int(valid.sum())} kept={int(want.sum())}{near} "
            f"keep mismatches={bad}")
        if bad:
            raise AssertionError(f"CUDA NMS disagrees with plain: {case} "
                                 f"K={k} bs={bs} t={iou_t}: {bad} keep "
                                 "entries")
        if bs == 128 and (case == "dense" and k in (128, 512, 1024, 2048)
                          or case in ("many", "chain") and k == 2048):
            t = {"case": case, "K": k, "bs": bs, **time_kernel(
                nms, nms_kernel, boxes, cls, valid, iou_t, 3)}
            timings.append(t)
            log(f"nms timing {case} K={k} bs={bs}: greedy_keep {t['ms']:.4f}"
                f" ms device, {t['call_ms']:.4f} ms per call, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
                f"({t['bound_by']}), valid/kept per image "
                f"{t['valid_per_image']:.3f}/{t['kept_per_image']:.3f}")
    log(f"kernel-vs-plain: {len(cases)} cases, 0 mismatches")
    return timings


# -- phase 4: main path -------------------------------------------------------

def main_path(card: str) -> dict:
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops import nms
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import candidates, fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    cfg = Config()
    bs, k = 128, cfg.topk_for_conf(0.25)
    kw = dict(conf_threshold=0.25, iou_threshold=cfg.nms_iou_thresh,
              max_detections=cfg.max_detections, pre_nms_topk=k)
    sd, sidecar = load_flagship(fold=True, device="cuda")
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, fused=True)
    model.load_state_dict(sd, strict=True)
    model = model.to(device="cuda", dtype=torch.bfloat16,
                      memory_format=torch.channels_last).eval()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = [to_uint8(synth_batch(gen, bs, 640, cfg.nc)[0])
              for _ in range(3)]
    torch.cuda.synchronize()

    def run(x_u8, backend="auto"):
        preds = model(normalize_uint8(x_u8, torch.bfloat16))
        return preds, fused_detect(preds, anchors, backend=backend, **kw)

    # bf16 normalize on the card equals the CPU's for all 256 codes (the
    # CPU's is held equal to the JAX package's in the tests)
    codes = torch.arange(256, dtype=torch.uint8)
    if not torch.equal(normalize_uint8(codes.cuda(), torch.bfloat16).cpu(),
                       normalize_uint8(codes, torch.bfloat16)):
        raise AssertionError("bf16 normalize differs between card and CPU")

    with torch.inference_mode():
        nms_kernel.keep_launches = 0
        preds, (det, valid) = run(frames[0])
        times = []
        for r in range(2 + 9):                     # 2 warmup rounds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(frames[r % len(frames)])[1][1].sum().item()
            if r >= 2:
                times.append(time.perf_counter() - t0)
        launches = nms_kernel.keep_launches
        if launches < 1:
            raise AssertionError("the main path did not launch the CUDA NMS "
                                 "kernel")

        det_p, valid_p = fused_detect(preds, anchors, backend="torch", **kw)
        if not (torch.equal(valid, valid_p) and torch.equal(det, det_p)):
            raise AssertionError("fused_detect: cuda and torch backends differ")
        if not torch.isfinite(det).all():
            raise AssertionError("non-finite detections")
        thresh = float(np.log(0.25 / 0.75))
        obj = torch.cat([p[..., 4].reshape(bs, -1) for p in preds], 1)
        survivors = float((obj.float() > thresh).sum(1).float().mean())
        dets = float(valid.sum(1).float().mean())
        ref = sidecar["density_at_conf_0.25"]["structured"]
        log(f"main path: gate survivors/image {survivors:.3f} (sidecar "
            f"{ref['gate_survivors_per_image']}), detections/image {dets:.3f}"
            f" (sidecar {ref['detections_per_image']})")
        if dets < 1.0:
            raise AssertionError(f"{dets} detections per image: the layout "
                                 "or weight bridge is broken")
        ips = bs / statistics.median(times)
        log(f"main path: {ips:.2f} images/s (median of {len(times)} rounds, "
            f"bs {bs}, 640x640 uint8 on device, normalize+model+fused_detect)"
            f" on {card}")

        # the kernel on the main path's own NMS input, and on the
        # evaluator's (the same predictions at its conf gate and K), each
        # against the plain fixpoint on the same input
        iou_t = kw["iou_threshold"]
        boxes, cls, conf, cvalid = candidates(preds, anchors, (8, 16, 32),
                                              0.25, k)
        boxes, cls, cvalid = (t.contiguous() for t in (boxes, cls, cvalid))
        kernel = {"launches": launches, **time_kernel(
            nms, nms_kernel, boxes, cls, cvalid, iou_t, 5)}
        ev = candidates(preds, anchors, (8, 16, 32), cfg.conf_threshold,
                        cfg.pre_nms_topk)
        ev = [t.contiguous() for t in (ev[0], ev[1], ev[3])]
        evaluator = {"conf": cfg.conf_threshold, "K": cfg.pre_nms_topk,
                     "bs": bs, **time_kernel(nms, nms_kernel, *ev, iou_t, 3)}
        log(f"main-path NMS bs={bs} K={k}: {json.dumps(kernel)}")
        log(f"evaluator-shape NMS: {json.dumps(evaluator)}")
        if kernel["mismatches"] or evaluator["mismatches"]:
            raise AssertionError("greedy_keep differs from the plain fixpoint "
                                 "on the main path's or the evaluator's input")
        got = nms_kernel.greedy_keep_cuda(boxes, cls, cvalid, iou_t)

        # where a round's time goes: each stage alone on the same batch
        x = normalize_uint8(frames[0], torch.bfloat16)
        stages = {
            "normalize": cuda_ms(
                lambda: normalize_uint8(frames[0], torch.bfloat16), 10),
            "model": cuda_ms(lambda: model(x), 10),
            "gate_topk_decode": cuda_ms(lambda: candidates(
                preds, anchors, (8, 16, 32), 0.25, k), 10),
            "nms_kernel": kernel["call_ms"],
            "compact": cuda_ms(lambda: nms._compact(
                boxes, cls, conf, got, cfg.max_detections), 10),
            "round": 1e3 * statistics.median(times),
        }
        log("main-path stages (ms, CUDA events, median): "
            + json.dumps({n: round(t, 4) for n, t in stages.items()}))
    return {"model": model, "frames": frames,
            "valid_counts": valid.sum(1).cpu(), "kernel": kernel,
            "evaluator": evaluator, "images_per_s": ips, "stages": stages,
            "detections_per_image": dets, "survivors_per_image": survivors}


# -- phase 5: server ------------------------------------------------------------

def serve_frames(model) -> int:
    from yolov5m_tpu_torch.config import COCO_LABELS
    from yolov5m_tpu_torch.data.native import encode_ppm
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import (DetectionClient,
                                                  DetectionServer)

    gen = torch.Generator(device="cuda").manual_seed(1)
    scenes = to_uint8(synth_batch(gen, 16, 640, 80)[0]).cpu().numpy()
    # distinct heights identify each reply; 48x-x640 frames need no resize
    frames = [encode_ppm(scenes[i, :480 + 2 * i]) for i in range(16)]
    server = DetectionServer(model, normalized_anchors(), labels=COCO_LABELS,
                             batch_size=16, conf_threshold=0.25,
                             max_wait_ms=5.0)
    server.start()
    replies = [None, None]
    try:
        nms_kernel.keep_launches = 0

        def client(c):
            mine = list(range(c, 16, 2))
            with DetectionClient(port=server.port) as cl:
                for i in mine:                      # pipelined
                    cl.send(frames[i])
                replies[c] = [(i, cl.recv()) for i in mine]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = nms_kernel.keep_launches
    finally:
        server.stop()
    if any(t.is_alive() for t in threads) or None in replies:
        raise AssertionError("a client did not finish")
    n_det = 0
    for pairs in replies:
        for i, resp in pairs:
            if not resp.get("ok") or resp["height"] != 480 + 2 * i \
                    or resp["width"] != 640:
                raise AssertionError(f"reply for frame {i} wrong or out of "
                                     f"order: {str(resp)[:200]}")
            n_det += len(resp["detections"])
    log(f"server: 16 frames from 2 clients answered in order, {n_det} "
        f"detections, kernel launches while serving {launches}")
    if n_det < 1:
        raise AssertionError("the server found no detection in 16 scenes")
    if launches < 1:
        raise AssertionError("the server did not launch the CUDA NMS kernel")
    return launches


# -- phase 6: training and evaluation ----------------------------------------

def _finite(metrics: dict) -> bool:
    return all(bool(torch.isfinite(v)) for v in metrics.values())


def train_steps(card: str) -> dict:
    """6a: full-width YOLOv5m from the flagship weights (unfused, f32
    master weights, bf16 activations, channels_last) trained on synthetic
    bs-16 batches at 512/576/640, accumulate 4: 4 warmup micro-batches,
    then 16 timed ones (4 optimizer updates), each update ending in a
    device sync; then each stage timed alone with CUDA events."""
    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.data.loaders import default_multiscale_sizes
    from yolov5m_tpu_torch.data.synthetic import SyntheticLoader
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import (Trainer, YoloAdam,
                                                 accumulation_steps)

    cfg = Config()
    bs, warmup, timed = 16, 4, 16
    sd, _ = load_flagship(fold=False, device="cuda")
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc,
                   compute_dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    model = model.to(device="cuda", memory_format=torch.channels_last)
    accumulate = accumulation_steps(bs, cfg.nominal_batch_size)
    loss_fn = YoloLoss(LossConfig.from_config(cfg),
                       np.asarray(ANCHORS, np.float32))
    trainer = Trainer(model, loss_fn, YoloAdam(model.parameters(), cfg),
                      accumulate)
    sizes = default_multiscale_sizes(cfg.image_size)
    loader = SyntheticLoader(bs, steps=warmup + timed, nc=cfg.nc,
                             multi_scale_sizes=sizes, device="cuda")
    batches = [(b["image"], torch.from_numpy(b["labels"]).cuda(),
                torch.from_numpy(b["mask"]).cuda()) for b in loader]

    # the precision policy against f32 activations: the loss of the first
    # batch through a twin that computes in f32, on the same weights
    twin = YOLOv5(first_out=cfg.first_out, nc=cfg.nc).cuda().train()
    twin.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        loss_bf16 = loss_fn(model(batches[0][0]), *batches[0][1:])[1]
        loss_f32 = loss_fn(twin(batches[0][0]), *batches[0][1:])[1]
    model.load_state_dict(sd, strict=True)       # undo the BN stat update
    rel = {k: abs(float(loss_bf16[k]) / float(loss_f32[k]) - 1)
           for k in loss_f32}
    log("train loss parts, bf16 activations against f32: "
        + json.dumps({k: [float(loss_bf16[k]), float(loss_f32[k])]
                      for k in loss_f32}))
    del twin
    if max(rel.values()) > BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 loss parts differ from f32 by {rel}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    update_s, bad = [], []
    t0 = time.perf_counter()
    for i, (image, labels, mask) in enumerate(batches):
        m = trainer.train_step(image, labels, mask)
        if not _finite(m):
            bad.append(i)
        if (i + 1) % accumulate == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i >= warmup:
                update_s.append(t1 - t0)
            sizes_i = [b[0].shape[1] for b in batches[i + 1 - accumulate:i + 1]]
            log(f"train update {(i + 1) // accumulate}: sizes {sizes_i}"
                + "".join(f" {k} {float(v):.5f}" for k, v in m.items())
                + f", {t1 - t0:.4f} s" + ("" if i >= warmup else " (warmup)"))
            t0 = t1
    if bad:
        raise AssertionError(f"non-finite loss or grad_norm at micro-batches "
                             f"{bad}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ips = [accumulate * bs / t for t in update_s]
    images_per_s = statistics.median(ips)
    # what 6b scores: the EMA after these updates, before the stage timing
    # below moves the weights further
    ema_sd = {k: v.clone() for k, v in trainer.eval_state_dict().items()}

    # each stage alone on one 640 batch (BN statistics and weights keep
    # moving, as they would in training), on the card and on the host
    image, labels, mask = batches[0]
    preds = model(image)
    stages = {
        "forward": stage_ms(lambda _: model(image)),
        "loss_with_targets": stage_ms(lambda _: loss_fn(preds, labels, mask)),
        "backward": stage_ms(lambda total: total.backward(), prepare=lambda:
                             loss_fn(model(image), labels, mask)[0]),
        "optimizer_and_ema": stage_ms(lambda _: (trainer.optimizer.step(),
                                                 trainer.update_ema(9))),
    }
    trainer.optimizer.zero_grad(set_to_none=True)
    log(f"train: {images_per_s:.2f} images/s (median of {len(ips)} updates "
        f"of {accumulate} x bs {bs}, sizes {sizes}; each {ips}; median "
        f"update {1e3 * statistics.median(update_s):.4f} ms), peak memory "
        f"{peak_gib:.3f} GiB, on {card}")
    log("train stages at 640, bs 16 ([card ms, host ms to issue it], "
        "median of 5): " + json.dumps(
            {n: [round(t, 4) for t in v] for n, v in stages.items()}))
    return {"trainer": trainer, "flagship": sd, "ema": ema_sd,
            "images_per_s": images_per_s,
            "per_update_images_per_s": ips, "stages": stages,
            "peak_gib": peak_gib}


def evaluate(card: str, trained: dict) -> dict:
    """6b: the port's Evaluator on the flagship weights and on the EMA
    weights after 6a, over 4 fixed synthetic val batches of 16 at 640: one
    kernel launch per batch, the same dict with the plain NMS, map50 of
    the flagship at least 0.5; and the kernel timed on the eval loop's own
    NMS input (flagship predictions at conf 0.01, K 1024)."""
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.data.synthetic import SyntheticLoader
    from yolov5m_tpu_torch.eval.evaluator import Evaluator
    from yolov5m_tpu_torch.models.fuse import fold_batchnorm
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops import nms
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import candidates

    cfg = Config()
    model = trained["trainer"].model
    batches = list(SyntheticLoader(16, steps=4, nc=cfg.nc, train=False,
                                   device="cuda"))
    ev = Evaluator(model, normalized_anchors(), cfg)
    ev.run(trained["flagship"], batches)             # warmup: cuDNN plans
    nms_kernel.keep_launches = 0
    flagship = ev.run(trained["flagship"], batches)
    launches = nms_kernel.keep_launches
    timing = dict(ev.timing)
    plain = Evaluator(model, normalized_anchors(), cfg,
                      nms_backend="torch").run(trained["flagship"], batches)
    ema = ev.run(trained["ema"], batches)
    show = ("map50", "map75", "map", "class_accuracy", "obj_accuracy")
    log("eval flagship: " + json.dumps({k: flagship[k] for k in show}))
    log("eval EMA after 6a: " + json.dumps({k: ema[k] for k in show}))
    eval_ips = timing["images"] / timing["seconds"]
    host_share = timing["host_seconds"] / timing["seconds"]
    log(f"eval: {eval_ips:.2f} images/s over {timing['images']} images, "
        f"host matcher {host_share:.4f} of the wall time, kernel launches "
        f"{launches} for {len(batches)} batches, on {card}")
    if launches != len(batches):
        raise AssertionError(f"the evaluator launched the NMS kernel "
                             f"{launches} times for {len(batches)} batches")
    if plain != flagship:
        raise AssertionError("the evaluator's dict differs between the CUDA "
                             "kernel and the plain NMS")
    if not flagship["map50"] >= 0.5:
        raise AssertionError(f"flagship map50 {flagship['map50']} < 0.5: the "
                             "layout or the weight bridge is broken")
    if not all(np.isfinite(ema[k]) for k in show):
        raise AssertionError("non-finite metrics on the EMA weights")

    # the kernel on the eval loop's own input: batch 0's flagship
    # predictions through the fused model, gated at conf 0.01, K 1024
    fused = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, fused=True,
                   compute_dtype=torch.bfloat16)
    fused.load_state_dict(fold_batchnorm(trained["flagship"]), strict=True)
    fused = fused.to(device="cuda", memory_format=torch.channels_last).eval()
    with torch.no_grad():
        preds = fused(batches[0]["image"])
    boxes, cls, _, valid = candidates(preds, normalized_anchors(),
                                      (8, 16, 32), cfg.conf_threshold,
                                      cfg.pre_nms_topk)
    loop = {"conf": cfg.conf_threshold, "K": cfg.pre_nms_topk, "bs": 16,
            **time_kernel(nms, nms_kernel, boxes.contiguous(),
                          cls.contiguous(), valid.contiguous(),
                          cfg.nms_iou_thresh, 3)}
    log(f"eval-loop NMS: {json.dumps(loop)}")
    if loop["mismatches"]:
        raise AssertionError("greedy_keep differs from the plain fixpoint "
                             "on the eval loop's input")
    return {"launches": launches, "flagship": {k: flagship[k] for k in show},
            "ema": {k: ema[k] for k in show}, "images_per_s": eval_ips,
            "host_share": host_share, "kernel": loop}


def train_cli_cycle(trained: dict) -> tuple:
    """6c: the train CLI in a temporary directory: one epoch from the
    flagship weights (--load_coco_weights), then --resume for one more;
    both checkpoints and two eval rows must be written. Returns the NMS
    kernel launches of the two runs' evaluations, and the second
    checkpoint stripped for deployment (9e loads it)."""
    from yolov5m_tpu_torch.cli import train as train_cli
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.utils.checkpoint import strip_checkpoint

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "flagship.npz")
        np.savez(npz, **{k: v.cpu().numpy()
                         for k, v in trained["flagship"].items()})
        args = ["--data", "synth", "--bs", "16", "--epochs", "1",
                "--synth_steps", "8", "--synth_val_batches", "2",
                "--filename", "model_1"]
        real_dump = train_cli.dump_prediction_images
        image_launches = []

        def dump(*a, **kw):
            before = nms_kernel.keep_launches
            real_dump(*a, **kw)
            image_launches.append(nms_kernel.keep_launches - before)

        os.chdir(tmp)
        train_cli.dump_prediction_images = dump
        try:
            nms_kernel.keep_launches = 0
            train_cli.main(train_cli.arg_parser(
                args + ["--load_coco_weights", "--weights", npz]))
            train_cli.main(train_cli.arg_parser(
                args + ["--resume", "--nosaveimgs"]))
            launches = nms_kernel.keep_launches
            images = epoch_images(os.path.join("SAVED_IMAGES", "model_1",
                                               "EPOCH_1"), 5)
            run = os.path.join("SAVED_CHECKPOINT", "model_1")
            for e in (1, 2):
                if not os.path.isfile(os.path.join(
                        run, f"checkpoint_epoch_{e}.pt")):
                    raise AssertionError(f"no checkpoint_epoch_{e}.pt")
            with open(os.path.join("train_eval_metrics", "model_1",
                                   "eval.csv")) as f:
                rows = f.read().strip().splitlines()
            stripped = strip_checkpoint(torch.load(
                os.path.join(run, "checkpoint_epoch_2.pt"),
                map_location="cpu", weights_only=True),
                YOLOv5(first_out=48, nc=80))
        finally:
            train_cli.dump_prediction_images = real_dump
            os.chdir(cwd)
    log(f"train CLI: checkpoint_epoch_1.pt and _2.pt written, eval.csv "
        f"{rows}, kernel launches {launches} ({image_launches} for the "
        f"prediction images), images {images}")
    if len(rows) != 3 or not rows[0].startswith("epoch,"):
        raise AssertionError(f"eval.csv should hold a header and 2 rows: "
                             f"{rows}")
    if image_launches != [1] or launches != 5:
        raise AssertionError(f"the CLI launched the NMS kernel {launches} "
                             f"times ({image_launches} for the images), not "
                             f"2 epochs x 2 batches and 1 for the images")
    return launches, image_launches[0], stripped


def epoch_images(folder: str, n: int) -> list:
    """The (h, w) of image_0..image_{n-1}.png in folder, each read by the
    port's PNG decoder (RGB) and by the tests' RGBA reader, which must
    agree; a missing or unreadable file raises."""
    from yolov5m_tpu_torch.data import native

    cases = tests_module("torch_plot_cases")
    names = sorted(os.listdir(folder))
    want = [f"image_{i}.png" for i in range(n)]
    if names != want:
        raise AssertionError(f"{folder} holds {names}, not {want}")
    shapes = []
    for name in names:
        path = os.path.join(folder, name)
        with open(path, "rb") as f:
            rgb = native.decode_png(f.read())
        rgba = cases.decode(path)
        if rgb is None or not np.array_equal(rgb, rgba[..., :3]) \
                or not (rgba[..., 3] == 255).all():
            raise AssertionError(f"{path} does not decode to an opaque image")
        shapes.append(list(rgba.shape[:2]))
    return shapes


# -- phase 7: disk data and detect, full width ---------------------------------

# the phase's sizes: 64 train and 40 val scenes (3 val batches of 16, the
# last one short) at two non-square source sizes (h, w), bs 16 at 640 and
# the JAX CLI's auto-remat batch of 96; the model and the gates
P7 = {"n_train": 64, "n_val": 40, "src_hw": ((480, 640), (540, 960)),
      "size": 640, "bs": 16, "big_bs": 96, "first_out": 48, "depth": 0.67,
      "model": "m", "workers": 4, "min_map50": 0.5, "min_dets": 1.0}


def write_disk_dataset(root: str) -> dict:
    """7a: a COCO-format disk dataset of PPM images under root: synthetic
    640x640 scenes resized to the non-square source sizes, labels as
    "x1 y1 w h class+1" in source pixels, data.yaml with nc 80."""
    from yolov5m_tpu_torch.config import COCO_LABELS
    from yolov5m_tpu_torch.data.native import encode_ppm, resize_bilinear
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8

    gen = torch.Generator(device="cuda").manual_seed(7)
    n_bytes = 0
    for split in ("train", "val"):
        n = P7[f"n_{split}"]
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(root, sub, split))
        for start in range(0, n, 16):
            img, labels, mask = synth_batch(gen, 16, 640, len(COCO_LABELS))
            img = to_uint8(img).cpu().numpy()
            labels, mask = labels.cpu().numpy(), mask.cpu().numpy()
            for j in range(min(16, n - start)):
                i = start + j
                h, w = P7["src_hw"][i % len(P7["src_hw"])]
                data = encode_ppm(resize_bilinear(img[j], (w, h)))
                n_bytes += len(data)
                with open(os.path.join(root, "images", split,
                                       f"{i:04d}.ppm"), "wb") as f:
                    f.write(data)
                rows = [f"{(cx - bw / 2) * w:.2f} {(cy - bh / 2) * h:.2f} "
                        f"{bw * w:.2f} {bh * h:.2f} {int(c) + 1}"
                        for c, cx, cy, bw, bh in labels[j][mask[j]]]
                with open(os.path.join(root, "labels", split,
                                       f"{i:04d}.txt"), "w") as f:
                    f.write("\n".join(rows))
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write(f"nc: {len(COCO_LABELS)}\n"
                f"names: {json.dumps(list(COCO_LABELS))}\n")
    log(f"disk dataset: {P7['n_train']} train and {P7['n_val']} val PPM "
        f"scenes at {P7['src_hw']} (h, w), {n_bytes / 2 ** 20:.1f} MiB")
    return {"mib": n_bytes / 2 ** 20}


def _p7_model(sd, remat: bool = False):
    from yolov5m_tpu_torch.models.yolo import YOLOv5

    model = YOLOv5(first_out=P7["first_out"], nc=80, depth_mult=P7["depth"],
                   compute_dtype=torch.bfloat16, remat=remat)
    model.load_state_dict(sd, strict=True)
    return model.to(device="cuda", memory_format=torch.channels_last)


def _p7_trainer(sd, bs: int):
    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import (Trainer, YoloAdam,
                                                 accumulation_steps)

    cfg = Config(first_out=P7["first_out"])
    model = _p7_model(sd)
    return Trainer(model, YoloLoss(LossConfig.from_config(cfg),
                                   np.asarray(ANCHORS, np.float32)),
                   YoloAdam(model.parameters(), cfg),
                   accumulation_steps(bs, cfg.nominal_batch_size))


def _update(trainer, batches) -> tuple:
    """One optimizer update over ``batches`` (accumulate micro-batches):
    (host seconds to a device sync, the micro-batches' metrics)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(*b) for b in batches]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def _host_metrics(metrics) -> list:
    return [{k: float(v) for k, v in m.items()} for m in metrics]


def disk_training(card: str, root: str, flagship: dict) -> dict:
    """7b and 7c: the Trainer on the disk loader (get_loaders with 4
    workers, multi-scale 512/576/640, device mosaic 0.5, device HSV, color
    jitter and flips through the train CLI's own device step) at bs 16,
    accumulate 4: 1 warmup and 3 timed updates; then one update at bs 16
    without remat, with remat "c3" and with "all" from the same state on
    the same batches; then one step at bs 96, 640, without and with remat."""
    from yolov5m_tpu_torch.cli import train as train_cli
    from yolov5m_tpu_torch.data.loaders import (default_multiscale_sizes,
                                                get_loaders, to_device)
    from yolov5m_tpu_torch.data.synthetic import synth_batch

    bs = P7["bs"]
    opt = train_cli.arg_parser(["--mosaic", "0.5", "--hsv", "--device_mosaic",
                                "--device_augment"])
    augment = train_cli.device_augment_step(opt, True, True)
    train_loader, _ = get_loaders(
        root, bs, max_boxes=120, default_size=P7["size"],
        multi_scale_sizes=default_multiscale_sizes(P7["size"]),
        num_workers=P7["workers"], mosaic_p=0.0, hsv=False,
        device_augment=True)
    # the host's work for one batch on one thread, without prefetch
    build_ms = []
    for b in range(3):
        t0 = time.perf_counter()
        train_loader._make_batch(np.arange(b * bs, (b + 1) * bs), b, 0)
        build_ms.append(1e3 * (time.perf_counter() - t0))
    trainer = _p7_trainer(flagship, bs)
    acc = trainer.accumulate
    per_epoch = len(train_loader)
    n_updates = 4                                   # 1 warmup + 3 timed
    wait_ms, aug_ms, update_s, bad, staged = [], [], [], [], []
    step, t_update = 0, None
    for epoch in range(1, n_updates * acc // per_epoch + 1):
        train_loader.set_epoch(epoch)
        it = iter(train_loader)
        while True:
            if step % acc == 0:
                torch.cuda.synchronize()
                t_update = time.perf_counter()
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            wait_ms.append(1e3 * (time.perf_counter() - t0))
            image, labels, mask = (to_device(batch[k], torch.device("cuda"))
                                   for k in ("image", "labels", "mask"))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            image, labels, mask = augment(epoch * 100000 + step, image,
                                          labels, mask)
            end.record()
            m = trainer.train_step(image, labels, mask)
            if not _finite(m):
                bad.append(step)
            if step < acc:
                staged.append((image, labels, mask))
            end.synchronize()
            aug_ms.append(start.elapsed_time(end))
            step += 1
            if step % acc == 0:
                torch.cuda.synchronize()
                update_s.append(time.perf_counter() - t_update)
    train_loader.close()
    if bad:
        raise AssertionError(f"non-finite loss or grad_norm on disk batches "
                             f"{bad}")
    ips = [acc * bs / t for t in update_s[1:]]
    disk_ips = statistics.median(ips)
    log(f"disk train: {disk_ips:.2f} images/s (median of {len(ips)} updates "
        f"of {acc} x bs {bs}; each {ips}), loader wait per batch "
        f"{statistics.median(wait_ms):.4f} ms (median; max "
        f"{max(wait_ms):.4f}), one thread builds a batch in "
        f"{statistics.median(build_ms):.4f} ms, device augment "
        f"{statistics.median(aug_ms):.4f} ms per batch, on {card}")

    # remat at bs 16: the same state and staged batches, three ways
    snapshot = clone_state(trainer.state_dict())
    remat16 = {}
    for scope in (None, "c3", "all"):
        trainer.model.remat = scope is not None
        trainer.model.remat_scope = scope or "c3"
        runs = []
        for _ in range(2):                          # warmup, then timed
            trainer.load_state_dict(clone_state(snapshot))
            torch.cuda.reset_peak_memory_stats()
            runs.append(_update(trainer, staged))
        seconds, metrics = runs[1]
        remat16[scope or "none"] = {
            "images_per_s": acc * bs / seconds,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss_parts": _host_metrics(metrics)}
    base = remat16["none"]["loss_parts"]
    for scope in ("c3", "all"):
        for got, want in zip(remat16[scope]["loss_parts"], base):
            rel = max(abs(got[k] / want[k] - 1) for k in ("box", "obj", "cls"))
            if rel > BF16_LOSS_RTOL:
                raise AssertionError(f"remat {scope} loss parts {got} differ "
                                     f"from no remat {want}")
    log(f"remat at bs {bs} (one update of {acc} micro-batches): " + json.dumps(
        {k: {"images_per_s": v["images_per_s"], "peak_gib": v["peak_gib"]}
         for k, v in remat16.items()}))
    del trainer, staged, snapshot
    torch.cuda.empty_cache()

    # remat at the JAX CLI's auto-remat batch: bs 96 at 640, accumulate 1
    big = P7["big_bs"]
    gen = torch.Generator(device="cuda").manual_seed(96)
    img, labels, mask = synth_batch(gen, big, P7["size"], 80, max_boxes=8)
    remat96 = {}
    for remat in (False, True):
        trainer = _p7_trainer(flagship, big)
        trainer.model.remat = remat
        _update(trainer, [(img, labels, mask)])          # warmup
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for _ in range(2):
            t, m = _update(trainer, [(img, labels, mask)])
            times.append(t)
            metrics += m
        if not all(_finite(m) for m in metrics):
            raise AssertionError(f"non-finite loss at bs {big}, remat {remat}")
        remat96["c3" if remat else "none"] = {
            "images_per_s": big / statistics.median(times),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del trainer
        torch.cuda.empty_cache()
    log(f"remat at bs {big}, {P7['size']}: " + json.dumps(remat96))
    return {"images_per_s": disk_ips, "per_update": ips,
            "loader_wait_ms": statistics.median(wait_ms),
            "loader_build_ms": statistics.median(build_ms),
            "augment_ms": statistics.median(aug_ms),
            "remat_bs16": {k: {"images_per_s": v["images_per_s"],
                               "peak_gib": v["peak_gib"]}
                           for k, v in remat16.items()},
            "remat_bs96": remat96}


def clone_state(state):
    """A deep copy of a training state (tensors cloned on their device)."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(clone_state(v) for v in state)
    return state


def disk_evaluate(card: str, root: str, flagship: dict,
                  label: str = "7d disk eval") -> dict:
    """7d: the Evaluator on the disk val loader (40 images, 3 batches, the
    last short): one kernel launch per batch, the same dict with the plain
    NMS, flagship map50 >= 0.5, and the COCO dump's ground truth back in
    each image's source pixels (orig_hw) against its label file."""
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.data.loaders import get_loaders
    from yolov5m_tpu_torch.eval.evaluator import Evaluator
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    cfg = Config(first_out=P7["first_out"])
    _, val_loader = get_loaders(root, P7["bs"], max_boxes=120,
                                default_size=P7["size"],
                                num_workers=P7["workers"])
    model = _p7_model(flagship)
    ev = Evaluator(model, normalized_anchors(), cfg)
    with tempfile.TemporaryDirectory() as dump:
        ev.run(flagship, val_loader, coco_dump_dir=dump)     # and warmup
        with open(os.path.join(dump, "annotations.json")) as f:
            ann = json.load(f)
    names = [n for n, _, _ in val_loader.ds.annotations]
    worst = 0.0
    for im in ann["images"]:
        h0, w0 = val_loader.ds.orig_sizes[names[im["id"]]]
        if (im["height"], im["width"]) != (h0, w0):
            raise AssertionError(f"COCO dump image {im} is not at its source "
                                 f"size {(h0, w0)}")
    for i, name in enumerate(names):
        with open(os.path.join(root, "labels", "val",
                               os.path.splitext(name)[0] + ".txt")) as f:
            want = np.loadtxt(f, ndmin=2)
        got = np.asarray([a["bbox"] + [a["category_id"] + 1]
                          for a in ann["annotations"] if a["image_id"] == i])
        if got.shape != want.shape:
            raise AssertionError(f"{name}: {got.shape} GT boxes in the dump, "
                                 f"{want.shape} in the label file")
        worst = max(worst, float(np.abs(got - want).max()))
    if worst > 0.05:
        raise AssertionError(f"GT boxes rescaled to orig_hw are {worst} px off "
                             "the label files")
    nms_kernel.keep_launches = 0
    results = ev.run(flagship, val_loader)
    launches = nms_kernel.keep_launches
    timing = dict(ev.timing)
    plain = Evaluator(model, normalized_anchors(), cfg,
                      nms_backend="torch").run(flagship, val_loader)
    val_loader.close()
    show = ("map50", "map75", "map", "class_accuracy", "obj_accuracy")
    ips = timing["images"] / timing["seconds"]
    host_share = timing["host_seconds"] / timing["seconds"]
    log(f"{label} flagship: " + json.dumps({k: results[k] for k in show})
        + f"; {ips:.2f} images/s over {timing['images']} images (padding "
        f"included), host matcher {host_share:.4f} of the wall time, kernel "
        f"launches {launches} for {len(val_loader)} batches, GT in source "
        f"pixels within {worst:.4f} px of the label files, on {card}")
    if launches != len(val_loader):
        raise AssertionError(f"disk eval launched the NMS kernel {launches} "
                             f"times for {len(val_loader)} batches")
    if plain != results:
        raise AssertionError("the disk evaluator's dict differs between the "
                             "CUDA kernel and the plain NMS")
    if not results["map50"] >= P7["min_map50"]:
        raise AssertionError(f"flagship map50 {results['map50']} < "
                             f"{P7['min_map50']} on the disk val set")
    return {"launches": launches, "metrics": {k: results[k] for k in show},
            "images_per_s": ips, "host_share": host_share,
            "orig_hw_px": worst}


def _quiet(fn, *args, **kwargs):
    """fn's result and its standard output, captured."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def detect_cli(card: str, root: str, npz: str,
               label: str = "7e detect CLI") -> dict:
    """7e: cli.detect.main --all over the val PPM directory at bs 16: the
    kernel launched once per batch, the results dict equal to the plain
    NMS's, >= 1.0 detections an image; then images/s of the directory
    loop (host decode and letterbox included) on a built model."""
    from yolov5m_tpu_torch.cli import detect
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    img_dir = os.path.join(root, "images", "val")
    args = ["--img_dir", img_dir, "--all", "--bs", str(P7["bs"]), "--nc",
            "80", "--weights", npz, "--model", P7["model"], "--first_out",
            str(P7["first_out"]), "--image_size", str(P7["size"]),
            "--device", "cuda"]
    n = len(detect.list_images(img_dir))
    nms_kernel.keep_launches = 0
    results, _ = _quiet(detect.main, detect.arg_parser(args))
    launches = nms_kernel.keep_launches
    plain, _ = _quiet(detect.main, detect.arg_parser(args),
                      nms_backend="torch")
    per_image = sum(len(v) for v in results.values()) / n
    ips = detect_dir_rate(detect.arg_parser(args), n)
    want = -(-n // P7["bs"])
    log(f"{label} --all: {n} images, {per_image:.3f} detections/image, "
        f"kernel launches {launches} (ceil(n/bs) = {want}), {ips:.2f} "
        f"images/s (median of 3, host decode and letterbox included), on "
        f"{card}")
    if launches != want:
        raise AssertionError(f"detect launched the NMS kernel {launches} "
                             f"times for {n} images at bs {P7['bs']}")
    if plain != results:
        raise AssertionError("detect results differ between the CUDA kernel "
                             "and the plain NMS")
    if per_image < P7["min_dets"]:
        raise AssertionError(f"{per_image} detections per image in detect")
    return {"launches": launches, "images_per_s": ips,
            "detections_per_image": per_image, "results": results}


def detect_save_pred(card: str, root: str, npz: str) -> dict:
    """7h: cli.detect.main --all --save_pred over the val PPM directory at
    bs 16: a *_pred.png for each image, read by the port's PNG decoder and
    equal, pixel for pixel, to the renderer called on detect's own
    results; ceil(n/bs) kernel launches; then images/s with and without
    --save_pred (the directory loop on a built model, as 7e)."""
    from yolov5m_tpu_torch.cli import detect
    from yolov5m_tpu_torch.config import COCO_LABELS
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.utils import plotting

    cases = tests_module("torch_plot_cases")
    img_dir = os.path.join(root, "images", "val")
    names = detect.list_images(img_dir)
    n = len(names)
    with tempfile.TemporaryDirectory() as out:
        args = ["--img_dir", img_dir, "--all", "--bs", str(P7["bs"]),
                "--nc", "80", "--weights", npz, "--model", P7["model"],
                "--first_out", str(P7["first_out"]), "--image_size",
                str(P7["size"]), "--device", "cuda", "--out", out]
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            args + ["--save_pred"]))
        launches = nms_kernel.keep_launches
        files = sorted(f for f in os.listdir(out) if f.endswith("_pred.png"))
        want_files = sorted(os.path.splitext(f)[0] + "_pred.png"
                            for f in names)
        wrong, drawn = [], 0
        for name in names:
            path = os.path.join(out, os.path.splitext(name)[0] + "_pred.png")
            if not os.path.isfile(path):
                wrong.append(name)
                continue
            with open(path, "rb") as f:
                rgb = native.decode_png(f.read())
            rgba = cases.decode(path)
            rows = np.array([[COCO_LABELS.index(d["class"]), d["conf"],
                              *d["box_xyxy"]] for d in results[name]],
                            np.float32).reshape(-1, 6)
            drawn += len(rows)
            raw = native.load_image_rgb(os.path.join(img_dir, name))
            direct = plotting.render_image(raw.astype(np.float32) / 255.0,
                                           rows, COCO_LABELS)
            if rgb is None or not np.array_equal(rgba, direct) or \
                    not np.array_equal(rgb, rgba[..., :3]):
                wrong.append(name)
        saving = detect.arg_parser(args + ["--save_pred"])
        plain = detect.arg_parser(args)
        ips = {"plain": detect_dir_rate(plain, n, COCO_LABELS),
               "save_pred": detect_dir_rate(saving, n, COCO_LABELS)}
    want = -(-n // P7["bs"])
    res = {"images": len(files), "launches": launches, "boxes_drawn": drawn,
           "differ_from_direct_render": wrong, "images_per_s": ips}
    log(f"7h detect CLI --all --save_pred: {json.dumps(res)} (images/s: "
        f"median of 3, host decode, letterbox and, with --save_pred, the "
        f"images included) on {card}")
    if files != want_files or wrong:
        raise AssertionError(f"7h: --save_pred wrote {len(files)} of {n} "
                             f"images, or they differ from the direct "
                             f"render: {wrong}")
    if launches != want:
        raise AssertionError(f"7h: detect launched the NMS kernel {launches} "
                             f"times for {n} images at bs {P7['bs']}")
    if drawn < n:
        raise AssertionError(f"7h: {drawn} boxes drawn over {n} images")
    return res


def disk_train_cli(root: str, npz: str) -> dict:
    """7f: the train CLI on the disk dataset, one epoch from the flagship
    npz with device mosaic, device augment, HSV and autoanchor, then
    --resume: both checkpoints, two eval rows, and anchors.json whenever
    the refit fires (reloaded on resume)."""
    from yolov5m_tpu_torch.cli import train as train_cli
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    cwd = os.getcwd()
    args = ["--data", os.path.basename(root), "--datasets_dir",
            os.path.dirname(root), "--bs", str(P7["bs"]), "--epochs", "1",
            "--nw", str(P7["workers"]), "--device_mosaic", "--mosaic", "0.5",
            "--device_augment", "--hsv", "--autoanchor", "--nosaveimgs",
            "--filename", "model_1", "--model", P7["model"], "--first_out",
            str(P7["first_out"]), "--image_size", str(P7["size"]),
            "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            nms_kernel.keep_launches = 0
            _, first = _quiet(train_cli.main, train_cli.arg_parser(
                args + ["--load_coco_weights", "--weights", npz]))
            _, second = _quiet(train_cli.main,
                               train_cli.arg_parser(args + ["--resume"]))
            launches = nms_kernel.keep_launches
            run = os.path.join("SAVED_CHECKPOINT", "model_1")
            for e in (1, 2):
                if not os.path.isfile(os.path.join(
                        run, f"checkpoint_epoch_{e}.pt")):
                    raise AssertionError(f"no checkpoint_epoch_{e}.pt")
            with open(os.path.join("train_eval_metrics", "model_1",
                                   "eval.csv")) as f:
                rows = f.read().strip().splitlines()
            has_anchors = os.path.isfile(os.path.join(run, "anchors.json"))
        finally:
            os.chdir(cwd)
    refit = "autoanchor: refit" in first
    for out in (first, second):
        for line in out.splitlines():
            if any(w in line for w in ("autoanchor", "anchors", "MAP50",
                                       "training_loss", "resumed", "==> /")):
                log(f"  train CLI: {line}")
    log(f"train CLI on disk: both checkpoints, eval.csv {rows}, refit "
        f"{refit}, anchors.json {has_anchors}, kernel launches {launches}")
    if len(rows) != 3 or not rows[0].startswith("epoch,"):
        raise AssertionError(f"eval.csv should hold a header and 2 rows: "
                             f"{rows}")
    if has_anchors != refit or refit != ("loaded run anchors" in second):
        raise AssertionError("anchors.json must be written exactly when the "
                             "refit fires, and reloaded on --resume")
    return {"launches": launches, "refit": refit}


def encode_png(img: np.ndarray) -> bytes:
    """(h, w, 3) uint8 -> an 8-bit RGB PNG (stdlib zlib), its rows cycling
    through the five filter types (none, sub, up, average, Paeth)."""
    import struct
    import zlib

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rows = img.reshape(h, w * 3).astype(np.int16)
    out = np.empty((h, 1 + w * 3), np.uint8)
    prev = np.zeros(w * 3, np.int16)
    pad = np.zeros(3, np.int16)
    for y in range(h):
        row, ftype = rows[y], y % 5
        left = np.concatenate([pad, row[:-3]])
        upleft = np.concatenate([pad, prev[:-3]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out[y, 0] = ftype
        out[y, 1:] = ((row - pred) & 0xFF).astype(np.uint8)
        prev = row

    def chunk(cid: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + cid + data
                + struct.pack(">I", zlib.crc32(cid + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png_twin(root: str, png_root: str) -> dict:
    """7g: phase 7's dataset under png_root with every PPM image written
    as a PNG of the same pixels, the same labels and data.yaml."""
    import shutil

    from yolov5m_tpu_torch.data.native import decode_ppm

    n_bytes = 0
    for split in ("train", "val"):
        os.makedirs(os.path.join(png_root, "images", split))
        shutil.copytree(os.path.join(root, "labels", split),
                        os.path.join(png_root, "labels", split))
        for name in sorted(os.listdir(os.path.join(root, "images", split))):
            with open(os.path.join(root, "images", split, name), "rb") as f:
                data = encode_png(decode_ppm(f.read()))
            n_bytes += len(data)
            with open(os.path.join(png_root, "images", split,
                                   os.path.splitext(name)[0] + ".png"),
                      "wb") as f:
                f.write(data)
    shutil.copy(os.path.join(root, "data.yaml"), png_root)
    return {"mib": n_bytes / 2 ** 20}


def png_host_training(card: str, png_root: str, flagship: dict,
                      ppm: dict) -> dict:
    """7g: the Trainer on the PNG dataset through get_loaders with the
    host's default TrainAugment, host mosaic 0.5 and host HSV (bs 16,
    accumulate 4, 1 warmup and 3 timed updates), each C op of the host
    augmentation counted; ppm: 7b's result, read for its rates."""
    import concurrent.futures as cf

    from yolov5m_tpu_torch.data import augment as host_aug
    from yolov5m_tpu_torch.data.loaders import (default_multiscale_sizes,
                                                get_loaders, to_device)

    bs = P7["bs"]
    loader, _ = get_loaders(
        png_root, bs, max_boxes=120, default_size=P7["size"],
        multi_scale_sizes=default_multiscale_sizes(P7["size"]),
        num_workers=P7["workers"], mosaic_p=0.5, hsv=True)
    n = len(loader.ds)

    def make(b):
        return loader._make_batch(np.arange(b * bs, (b + 1) * bs) % n, b, 0)

    one = []
    for b in range(P9["one_thread_batches"]):
        t0 = time.perf_counter()
        make(b)
        one.append(1e3 * (time.perf_counter() - t0))
    with cf.ThreadPoolExecutor(P9["pool_threads"]) as pool:
        t0 = time.perf_counter()
        list(pool.map(make, range(P9["pool_batches"])))
        pooled = 1e3 * (time.perf_counter() - t0) / P9["pool_batches"]
    build = {"one_thread_ms": statistics.median(one),
             "four_threads_ms_a_batch": pooled}

    trainer = _p7_trainer(flagship, bs)
    acc = trainer.accumulate
    per_epoch = len(loader)
    update_s, parts, bad, step = [], [], [], 0
    host_aug.reset_calls()
    for epoch in range(1, 4 * acc // per_epoch + 1):
        loader.set_epoch(epoch)
        for batch in loader:
            if step % acc == 0:
                torch.cuda.synchronize()
                t_update = time.perf_counter()
            m = trainer.train_step(*(to_device(batch[k], torch.device("cuda"))
                                     for k in ("image", "labels", "mask")))
            if not _finite(m):
                bad.append(step)
            parts.append({k: float(v) for k, v in m.items()})
            step += 1
            if step % acc == 0:
                torch.cuda.synchronize()
                update_s.append(time.perf_counter() - t_update)
    calls = dict(host_aug.calls)
    loader.close()
    if bad:
        raise AssertionError(f"7g: non-finite loss or grad_norm on PNG "
                             f"batches {bad}")
    ips = [acc * bs / t for t in update_s[1:]]
    rate = statistics.median(ips)
    log(f"7g PNG disk train, host augmentation (default TrainAugment, "
        f"mosaic 0.5, HSV): {rate:.2f} images/s (median of {len(ips)} "
        f"updates of {acc} x bs {bs}) against 7b's {ppm['images_per_s']:.2f}"
        f" (PPM, device mosaic and augment); a batch's host build "
        f"{json.dumps(build)} against 7b's {ppm['loader_build_ms']:.2f} ms "
        f"on one thread; C op calls in the run {json.dumps(calls)}; last "
        f"loss parts {json.dumps(parts[-1])}, on {card}")
    return {"images_per_s": rate, "per_update": ips, "build": build,
            "calls": calls, "steps": step,
            "ppm_images_per_s": ppm["images_per_s"],
            "ppm_build_one_thread_ms": ppm["loader_build_ms"]}


def png_phase(card: str, root: str, npz: str, flagship: dict,
              disk: dict) -> dict:
    """7g: the PNG twin of phase 7's dataset through training with the
    host augmentation, the evaluator and detect. disk: 7b-7e's results."""
    from yolov5m_tpu_torch.data import augment as host_aug

    png_root = root + "_png"
    data = write_png_twin(root, png_root)
    train = png_host_training(card, png_root, flagship, disk["train"])
    missing = [op for op, k in train["calls"].items() if k < 1]
    if missing:
        raise AssertionError(f"7g: the training run did not reach the host "
                             f"ops {missing}: {train['calls']}")
    ev = disk_evaluate(card, png_root, flagship, label="7g PNG eval")
    if ev["metrics"] != disk["eval"]["metrics"]:
        raise AssertionError(f"7g: the evaluator on the PNG twins gives "
                             f"{ev['metrics']}, on the PPM files "
                             f"{disk['eval']['metrics']}")
    det = detect_cli(card, png_root, npz, label="7g detect CLI over PNG")
    stem = {os.path.splitext(k)[0]: v for k, v in det.pop("results").items()}
    ppm = {os.path.splitext(k)[0]: v
           for k, v in disk["detect"]["results"].items()}
    if stem != ppm:
        raise AssertionError("7g: detect over the PNG scenes differs from "
                             "detect over their PPM twins")
    log(f"7g: {data['mib']:.1f} MiB of PNG; the evaluator's metrics and "
        f"detect's {len(stem)} results equal the PPM twins'; op calls "
        f"{json.dumps(host_aug.calls)} by the end of 7g")
    return {"data": data, "train": train,
            "eval": {k: v for k, v in ev.items() if k != "metrics"},
            "eval_launches": ev["launches"], "detect": det,
            "detect_launches": det["launches"]}


def disk_phase(card: str, flagship: dict, tmp: str) -> dict:
    """Phase 7, in the directory tmp, which holds the dataset (tmp/disk)
    and the flagship npz (tmp/flagship.npz) after it."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "disk")
    data = write_disk_dataset(root)
    npz = os.path.join(tmp, "flagship.npz")
    np.savez(npz, **{k: v.cpu().numpy() for k, v in flagship.items()})
    train = disk_training(card, root, flagship)
    ev = disk_evaluate(card, root, flagship)
    det = detect_cli(card, root, npz)
    save_pred = detect_save_pred(card, root, npz)
    cli = disk_train_cli(root, npz)
    png = png_phase(card, root, npz, flagship,
                    {"train": train, "eval": ev, "detect": det})
    log(f"phase 7 (disk data and detect): {time.perf_counter() - t0:.1f} s")
    return {"data": data, "train": train, "eval": ev, "detect": det,
            "save_pred": save_pred, "cli": cli, "png": png}


# -- phase 8: data parallelism on one card ----------------------------------

# the global batch at 640; 8a: accumulate and updates of the two-rank run;
# 8b: accumulate of the world-size-1 trainer, its timed rounds (each round
# plain, DP, DP, plain, one update each); 8c: the served batch (128 a
# replica) and its timed rounds
P8 = {"bs": 16, "size": 640, "acc_a": 2, "updates_a": 2, "acc_b": 4,
      "rounds_b": 3, "serve_bs": 256, "serve_rounds": 5}
# 8a against one process on the global batch, tests/test_trainer_dp.py's
# bounds: loss rtol, grad_norm rtol, parameters atol (+-2*lr, lr 5e-4, and
# float noise) and the share allowed beyond 1e-4 (fresh Adam turns a
# near-zero gradient of either sign into +-lr), BN buffers within 1e-4
# (relative above 1: the flagship's running variances reach the hundreds)
DP_LOSS_RTOL, DP_GNORM_RTOL = 1e-4, 1e-3
DP_PARAM_ATOL, DP_FLIP_AT, DP_FLIP_SHARE = 2.1e-3, 1e-4, 0.01
DP_BUFFER_TOL = 1e-4


def _p8_batches(n: int, seed: int) -> list:
    """n global batches of P8["bs"] structured scenes at P8["size"], made
    on the card from a seed: every process that asks gets the same."""
    from yolov5m_tpu_torch.data.synthetic import synth_batch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [synth_batch(gen, P8["bs"], P8["size"], 80) for _ in range(n)]


def _p8_trainer(sd, compute_dtype, accumulate: int, group=None,
                bn_group=None):
    """Full-width YOLOv5m from ``sd`` on the card: the plain Trainer, or
    with ``group`` the DP trainer (make_dp_train_step)."""
    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch.parallel.dp import make_dp_train_step
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam

    cfg = Config()
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc,
                   compute_dtype=compute_dtype, bn_group=bn_group)
    model.load_state_dict(sd, strict=True)
    model = model.to(device="cuda", memory_format=torch.channels_last)
    loss_fn = YoloLoss(LossConfig.from_config(cfg),
                       np.asarray(ANCHORS, np.float32))
    optimizer = YoloAdam(model.parameters(), cfg)
    if group is None:
        return Trainer(model, loss_fn, optimizer, accumulate)
    return make_dp_train_step(model, loss_fn, optimizer, accumulate, group)


def _host_state(trainer) -> dict:
    """The model's and the EMA's state dicts on the host."""
    return {part: {k: v.detach().cpu() for k, v in sd.items()}
            for part, sd in (("state", trainer.model.state_dict()),
                             ("ema", trainer.eval_state_dict()))}


def dp_parity_rank(rank: int, world: int, url: str, out_dir: str) -> None:
    """8a, one of two ranks on cuda:0 over gloo (spawned): the flagship at
    f32 with TF32 off and sync-BN, then at bf16 with local BN; each
    accumulate P8["acc_a"] for P8["updates_a"] updates on this rank's rows
    of the global batches. Writes its metrics and states to out_dir."""
    import torch.distributed as dist

    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.parallel.dp import (initialize_multihost,
                                               local_batch_slice)

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(url, world, rank, backend="gloo")
    try:
        sd, _ = load_flagship(fold=False, device="cuda")
        rows = local_batch_slice(P8["bs"])
        out = {}
        for name, dtype, sync in (("sync_f32", torch.float32, True),
                                  ("local_bf16", torch.bfloat16, False)):
            trainer = _p8_trainer(sd, dtype, P8["acc_a"],
                                  group=dist.group.WORLD,
                                  bn_group=dist.group.WORLD if sync else None)
            metrics = []
            for img, lab, msk in _p8_batches(
                    P8["acc_a"] * P8["updates_a"], seed=8):
                m = trainer.train_step(img[rows], lab[rows], msk[rows])
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = {"metrics": metrics, **_host_state(trainer)}
            del trainer
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_parity(card: str, flagship: dict) -> dict:
    """8a: two ranks spawned on cuda:0 over gloo against one process on the
    global batch (f32, TF32 off, sync-BN), within the bounds above; then
    the two ranks' bf16 local-BN states bitwise equal."""
    import torch.multiprocessing as mp

    from yolov5m_tpu_torch.parallel.dp import free_port

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(dp_parity_rank, nprocs=2, join=True,
                 args=(2, f"tcp://127.0.0.1:{free_port()}", tmp))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(2)]
    spawn_s = time.perf_counter() - t0
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = _p8_trainer(flagship, torch.float32, P8["acc_a"])
        want = [{k: float(v) for k, v in ref.train_step(*b).items()}
                for b in _p8_batches(P8["acc_a"] * P8["updates_a"], seed=8)]
        want_state = _host_state(ref)["state"]
        del ref
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    got = ranks[0]["sync_f32"]
    loss_rel = max(_rel(g[k], w[k]) for g, w in zip(got["metrics"], want)
                   for k in ("loss", "box", "obj", "cls"))
    gnorm_rel = max(_rel(g["grad_norm"], w["grad_norm"])
                    for g, w in zip(got["metrics"], want))
    param_err = buffer_err = 0.0
    flipped = total = 0
    for k, w in want_state.items():
        g = got["state"][k]
        d = (g - w).abs()
        if "running" in k:
            buffer_err = max(buffer_err, float(
                (d / w.abs().clamp(min=1.0)).max()))
        else:
            param_err = max(param_err, float(d.max()))
            flipped += int((d > DP_FLIP_AT).sum())
            total += d.numel()
    a, b = ranks[0]["local_bf16"], ranks[1]["local_bf16"]
    ranks_equal = a["metrics"] == b["metrics"] and all(
        torch.equal(v, b[part][k]) for part in ("state", "ema")
        for k, v in a[part].items())
    res = {"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
           "param_max_abs": param_err, "param_share_beyond_1e-4":
           flipped / total, "buffer_max_err": buffer_err,
           "bf16_ranks_bitwise_equal": ranks_equal,
           "grad_norm_dp": [m["grad_norm"] for m in got["metrics"]],
           "grad_norm_one_process": [m["grad_norm"] for m in want],
           "loss_dp": [m["loss"] for m in got["metrics"]],
           "loss_one_process": [m["loss"] for m in want],
           "seconds_two_ranks": spawn_s}
    log(f"8a two ranks on cuda:0 over gloo, sync-BN f32 against one process "
        f"on the global batch {P8['bs']}: {json.dumps(res)}, on {card}")
    if not (loss_rel <= DP_LOSS_RTOL and gnorm_rel <= DP_GNORM_RTOL
            and param_err <= DP_PARAM_ATOL
            and flipped / total < DP_FLIP_SHARE
            and buffer_err <= DP_BUFFER_TOL):
        raise AssertionError(f"8a: the two-rank sync-BN step is off the "
                             f"one-process step: {res}")
    if not ranks_equal:
        raise AssertionError("8a: the two ranks' bf16 local-BN states differ")
    return res


def dp_world1(card: str, flagship: dict) -> dict:
    """8b: NCCL at world size 1. The DP trainer (bf16, bs 16, accumulate
    P8["acc_b"]) from the flagship weights against the plain Trainer: one
    update's losses, grad norms, parameters, buffers and EMA exactly
    equal (deterministic cuDNN; a second plain run is the control). Then
    images/s of both, in rounds of plain, DP, DP, plain updates."""
    import torch.distributed as dist

    from yolov5m_tpu_torch.parallel.dp import free_port, initialize_multihost

    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        group = dist.group.WORLD
        batches = _p8_batches(P8["acc_b"], seed=9)
        flags = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs = {}
            for name in ("plain", "control", "dp"):
                t = _p8_trainer(flagship, torch.bfloat16, P8["acc_b"],
                                group=group if name == "dp" else None)
                metrics = [t.train_step(*b) for b in batches]
                runs[name] = ({k: [m[k].cpu() for m in metrics]
                               for k in metrics[0]}, _host_state(t))
                del t
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = flags

        def same(x, y):
            return (all(torch.equal(a, b) for k in x[0]
                        for a, b in zip(x[0][k], y[0][k]))
                    and all(torch.equal(v, y[1][p][k]) for p in x[1]
                            for k, v in x[1][p].items()))

        exact, control = (same(runs["dp"], runs["plain"]),
                          same(runs["control"], runs["plain"]))
        torch.cuda.empty_cache()

        plain = _p8_trainer(flagship, torch.bfloat16, P8["acc_b"])
        dpt = _p8_trainer(flagship, torch.bfloat16, P8["acc_b"], group=group)
        times = {"plain": [], "dp": []}
        for t in (plain, dpt):
            _update(t, batches)                          # warmup
        for _ in range(P8["rounds_b"]):
            for name, t in (("plain", plain), ("dp", dpt), ("dp", dpt),
                            ("plain", plain)):
                times[name].append(_update(t, batches)[0])
        del plain, dpt
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    ips = {n: P8["acc_b"] * P8["bs"] / statistics.median(v)
           for n, v in times.items()}
    res = {"exact": exact, "plain_repeat_exact": control,
           "images_per_s_plain": ips["plain"], "images_per_s_dp": ips["dp"],
           "dp_cost": 1 - ips["dp"] / ips["plain"],
           "update_s": {n: v for n, v in times.items()},
           "loss": [float(v) for v in runs["dp"][0]["loss"]],
           "grad_norm": [float(v) for v in runs["dp"][0]["grad_norm"]]}
    log(f"8b NCCL world size 1, bf16 bs {P8['bs']} accumulate {P8['acc_b']}:"
        f" {json.dumps(res)}, on {card}")
    if not exact:
        raise AssertionError(f"8b: the world-size-1 DP trainer differs from "
                             f"the plain Trainer (plain against plain "
                             f"exact: {control})")
    return res


def dp_train_cli(npz: str) -> int:
    """8b: the train CLI's rank path (``rank_main``) at world size 1 on
    NCCL: the DP trainer, rank 0's evaluation through the kernel, its
    checkpoint and eval row. Returns the evaluation's kernel launches."""
    from yolov5m_tpu_torch.cli import train as train_cli
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.parallel.dp import free_port

    opt = train_cli.arg_parser([
        "--data", "synth", "--bs", str(P8["bs"]), "--epochs", "1",
        "--synth_steps", "4", "--synth_val_batches", "2", "--nosaveimgs",
        "--filename", "model_1", "--load_coco_weights", "--weights", npz])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            nms_kernel.keep_launches = 0
            _, out = _quiet(train_cli.rank_main, 0, 1, opt, "cuda",
                            f"tcp://127.0.0.1:{free_port()}")
            launches = nms_kernel.keep_launches
            ok = os.path.isfile(os.path.join(
                "SAVED_CHECKPOINT", "model_1", "checkpoint_epoch_1.pt"))
            with open(os.path.join("train_eval_metrics", "model_1",
                                   "eval.csv")) as f:
                rows = f.read().strip().splitlines()
        finally:
            os.chdir(cwd)
    maps = [line for line in out.splitlines() if "MAP50" in line]
    log(f"8b DP train CLI at world size 1: checkpoint {ok}, eval.csv {rows},"
        f" {maps}, kernel launches {launches}")
    if not ok or len(rows) != 2 or launches != 2:
        raise AssertionError(f"8b: the DP train CLI wrote checkpoint {ok}, "
                             f"eval rows {rows}, launched the kernel "
                             f"{launches} times for 2 val batches")
    return launches


def dp_serving(card: str) -> dict:
    """8c: make_dp_infer_fn over ["cuda:0", "cuda:0"] at bs 256 on
    structured frames: det and valid exactly those of the one-device
    pipeline on each 128 shard, 2 kernel launches a batch, images/s; and
    DetectionServer(dp_devices=...) answers the phase-5 frames, sent
    pipelined by one client, with the rows of a one-device server whose
    batch is one replica's shard."""
    from yolov5m_tpu_torch.config import COCO_LABELS, Config
    from yolov5m_tpu_torch.data.native import encode_ppm
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
    from yolov5m_tpu_torch.parallel.infer import make_dp_infer_fn
    from yolov5m_tpu_torch.serving.server import (DetectionClient,
                                                  DetectionServer)

    cfg = Config()
    devices = ["cuda:0", "cuda:0"]
    kw = dict(conf_threshold=0.25, iou_threshold=cfg.nms_iou_thresh,
              max_detections=cfg.max_detections,
              pre_nms_topk=cfg.topk_for_conf(0.25))
    sd, _ = load_flagship(fold=True, device="cuda")
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, fused=True)
    model.load_state_dict(sd, strict=True)
    model = model.to(device="cuda", dtype=torch.bfloat16,
                     memory_format=torch.channels_last).eval()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    bs, per = P8["serve_bs"], P8["serve_bs"] // len(devices)
    gen = torch.Generator(device="cuda").manual_seed(10)
    frames = [to_uint8(synth_batch(gen, bs, 640, cfg.nc)[0])
              for _ in range(2)]
    infer = make_dp_infer_fn(model, normalized_anchors(), devices, **kw)
    nms_kernel.keep_launches = 0
    det, valid = infer(frames[0])
    torch.cuda.synchronize()
    first = nms_kernel.keep_launches
    with torch.inference_mode():
        for i in range(len(devices)):
            rows = slice(i * per, (i + 1) * per)
            want = fused_detect(model(normalize_uint8(
                frames[0][rows], torch.bfloat16)), anchors, **kw)
            if not (torch.equal(det[rows], want[0])
                    and torch.equal(valid[rows], want[1])):
                raise AssertionError(f"8c: DP serving shard {i} differs from "
                                     "the one-device pipeline")
    times, rounds = [], 2 + P8["serve_rounds"]             # 2 warmup
    nms_kernel.keep_launches = 0
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer(frames[r % 2])[1].sum().item()
        if r >= 2:
            times.append(time.perf_counter() - t0)
    launches = nms_kernel.keep_launches
    ips = bs / statistics.median(times)
    per_image = float(valid.sum(1).float().mean())

    gen = torch.Generator(device="cuda").manual_seed(1)    # phase 5's
    scenes = to_uint8(synth_batch(gen, 16, 640, 80)[0]).cpu().numpy()
    ppm = [encode_ppm(scenes[i, :480 + 2 * i]) for i in range(16)]
    replies = {}
    for name, extra in (("dp", dict(batch_size=16, dp_devices=devices)),
                        ("one", dict(batch_size=8))):
        server = DetectionServer(model, normalized_anchors(),
                                 labels=COCO_LABELS, conf_threshold=0.25,
                                 max_wait_ms=1000.0, **extra)
        with server, DetectionClient(port=server.port) as c:
            for f in ppm:                     # pipelined: full batches
                c.send(f)
            replies[name] = [c.recv() for _ in ppm]
    n_det = sum(len(r["detections"]) for r in replies["dp"])
    res = {"images_per_s": ips, "launches": launches,
           "launches_first_batch": first, "detections_per_image": per_image,
           "server_frames": len(ppm), "server_detections": n_det}
    log(f"8c DP serving over {devices} at bs {bs}: {json.dumps(res)}, on "
        f"{card}")
    if first != len(devices) or launches != len(devices) * rounds:
        raise AssertionError(f"8c: {first} launches for one batch, {launches}"
                             f" for {rounds}: not 2 a batch")
    if replies["dp"] != replies["one"] or not all(
            r.get("ok") for r in replies["dp"]):
        raise AssertionError("8c: the DP server's replies differ from the "
                             "one-device server's")
    if n_det < 1 or per_image < 1.0:
        raise AssertionError(f"8c: {n_det} detections in 16 served scenes, "
                             f"{per_image} an image at bs {bs}")
    return res


def dp_refusal() -> str:
    """8d: the train CLI with --dp 2 on one card exits before any work,
    naming the device count."""
    from yolov5m_tpu_torch.cli import train as train_cli

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            try:
                train_cli.main(train_cli.arg_parser(
                    ["--data", "synth", "--dp", "2", "--nosaveimgs"]))
                msg = None
            except SystemExit as e:
                msg = str(e)
            left = os.listdir(tmp)
        finally:
            os.chdir(cwd)
    log(f"8d train CLI --dp 2 on {torch.cuda.device_count()} card(s): "
        f"SystemExit {msg!r}, files left {left}")
    want = f"only {torch.cuda.device_count()} cuda devices"
    if msg is None or want not in msg or left:
        raise AssertionError(f"8d: --dp 2 on one card was not refused before "
                             f"any work: {msg!r}, {left}")
    return msg


def dp_phase(card: str, flagship: dict) -> dict:
    """Phase 8, data parallelism on one card."""
    t0 = time.perf_counter()
    parity = dp_parity(card, flagship)
    world1 = dp_world1(card, flagship)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "flagship.npz")
        np.savez(npz, **{k: v.cpu().numpy() for k, v in flagship.items()})
        eval_launches = dp_train_cli(npz)
    serving = dp_serving(card)
    refusal = dp_refusal()
    log(f"phase 8 (data parallelism on one card): "
        f"{time.perf_counter() - t0:.1f} s")
    return {"parity": parity, "world1": world1, "eval_launches":
            eval_launches, "serving": serving, "refusal": refusal}


# -- phase 9: host preprocessing, JPEG, the compact gate, export, a trace -----

# 9a: the scene sizes (h, w) of phase 7 and the square sizes its loader
# resizes them to; one-thread batch builds timed (median), batches built
# at once by four threads, letterboxes timed per arm; the C path's bound
# against numpy in codes. 9b: the JPEG fixtures' bound against their
# sources (mean absolute codes), decodes timed a case (median). 9c: timed
# rounds a gate (after 2 warmup rounds); the images held on the CPU above
# capacity and their gate: at conf 0.01 the flagship leaves tens of
# survivors an image on these scenes, inside K 512; at 1e-4 thousands
P9 = {"src_hw": ((480, 640), (540, 960)), "square": (640, 576, 512),
      "one_thread_batches": 3, "pool_batches": 8, "pool_threads": 4,
      "letterbox_reps": 20, "max_code_diff": 1, "max_jpeg_mad": 3.0,
      "decode_reps": 20, "op_reps": 20, "plot_reps": 5,
      "gate_rounds": 9, "cpu_images": 16, "low_conf": 1e-4,
      "export_rtol": 1e-4}
# the flagship's ONNX graph: the node counts tests/test_onnx_export.py
# holds for the JAX exporter
ONNX_COUNTS = {"Conv": 82, "Sigmoid": 79, "Mul": 79, "MaxPool": 3,
               "Resize": 2, "Add": 14, "Concat": 13, "Reshape": 3,
               "Transpose": 3}
# the device's events in a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path: str) -> tuple:
    """([(name, ms)] of the five device operations that took the most time,
    the device's idle share over the traced window, the window in ms) of
    a torch.profiler Chrome trace. The device is busy where any of its
    kernels, copies or sets runs; the window spans every timed event, the
    host's too."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    per_name = {}
    for e in device:
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    busy, start, end = 0.0, None, None
    for ts, dur in sorted((e["ts"], e["dur"]) for e in device):
        if end is None or ts > end:
            busy += 0.0 if end is None else end - start
            start, end = ts, ts + dur
        else:
            end = max(end, ts + dur)
    busy += 0.0 if end is None else end - start
    return ([(n, us / 1e3) for n, us in top], 1.0 - busy / window,
            window / 1e3)


def tests_module(name: str):
    """tests/{name}.py, loaded by its path: a package named "tests"
    elsewhere on sys.path would shadow the repo's directory."""
    import importlib.util

    path = os.path.join(REPO_ROOT, "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jpeg_fixtures():
    return tests_module("torch_jpeg_fixtures")


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def native_host(card: str, root: str) -> dict:
    """9a: the native library against numpy, and the loader's batch build
    with each (phase 7's dataset under root)."""
    import concurrent.futures as cf

    from yolov5m_tpu_torch.data import dataset, native
    from yolov5m_tpu_torch.data.loaders import (default_multiscale_sizes,
                                                get_loaders)

    native.build()                  # built in phase 2; raises if it cannot be
    jpeg = f"built ({os.path.relpath(native.JPEG_SOURCE, REPO_ROOT)})"
    log(f"9a native library: {native.build_command}")
    log(f"9a built in {native.build_seconds} s (None: built before this "
        f"process), JPEG decoder {jpeg}, {os.cpu_count()} host cores")
    scene = jpeg_fixtures().scene
    srcs = {hw: scene(i) for i, hw in enumerate(P9["src_hw"])}
    checks = []
    for (h, w), img in srcs.items():
        pairs = [(f"resize {w}x{h}->{s}x{s}",
                  native.resize_bilinear(img, (s, s)),
                  native.resize_bilinear_plain(img, (s, s)))
                 for s in P9["square"]]
        pairs.append((f"letterbox {w}x{h}->640",
                      native.letterbox(img, (640, 640))[0],
                      native.letterbox_plain(img, (640, 640))[0]))
        for name, c, p in pairs:
            d = np.abs(c.astype(np.int16) - p)
            checks.append({"op": name, "differing_pixels":
                           int((d.max(-1) > 0).sum()),
                           "max_diff": int(d.max())})
    log("9a C against numpy: " + json.dumps(checks))
    img = srcs[(540, 960)]
    letterbox_ms = {
        "c": _median_ms(lambda: native.letterbox(img, (640, 640)),
                        P9["letterbox_reps"]),
        "numpy": _median_ms(lambda: native.letterbox_plain(img, (640, 640)),
                            P9["letterbox_reps"])}
    log(f"9a one 960x540 -> 640 letterbox (ms, median of "
        f"{P9['letterbox_reps']}, one calling thread): "
        f"{json.dumps(letterbox_ms)} on {card}")

    bs = P7["bs"]
    loader, _ = get_loaders(
        root, bs, max_boxes=120, default_size=P7["size"],
        multi_scale_sizes=default_multiscale_sizes(P7["size"]),
        num_workers=P7["workers"], mosaic_p=0.0, hsv=False,
        device_augment=True)
    n = len(loader.ds)

    def make(b):
        return loader._make_batch(np.arange(b * bs, (b + 1) * bs) % n, b, 0)

    def build_ms():
        """(one thread's ms a batch, four threads' ms a batch, the first
        batch's images)"""
        one, first = [], None
        for b in range(P9["one_thread_batches"]):
            t0 = time.perf_counter()
            batch = make(b)
            one.append(1e3 * (time.perf_counter() - t0))
            first = batch["image"] if first is None else first
        with cf.ThreadPoolExecutor(P9["pool_threads"]) as pool:
            t0 = time.perf_counter()
            list(pool.map(make, range(P9["pool_batches"])))
            pooled = 1e3 * (time.perf_counter() - t0) / P9["pool_batches"]
        return statistics.median(one), pooled, first

    c_one, c_pool, c_first = build_ms()
    saved = dataset.resize_bilinear
    dataset.resize_bilinear = native.resize_bilinear_plain
    try:
        n_one, n_pool, n_first = build_ms()
    finally:
        dataset.resize_bilinear = saved
    loader.close()
    builds = {"c": {"one_thread_ms": c_one, "four_threads_ms_a_batch":
                    c_pool},
              "numpy": {"one_thread_ms": n_one, "four_threads_ms_a_batch":
                        n_pool}}
    # the host augment after the resize (a rotation) may spread a 1-code
    # resize difference: read, not held
    batch_diff = float(np.abs(c_first - n_first).max()) * 255.0
    log(f"9a loader batch build at bs {bs} (phase 7b's): "
        f"{json.dumps(builds)}, the two arms' first batch at most "
        f"{batch_diff:.4f} codes apart, on {card}")
    bad = [c for c in checks if c["max_diff"] > P9["max_code_diff"]]
    if bad:
        raise AssertionError(f"9a: the C path differs from numpy by more "
                             f"than {P9['max_code_diff']} code: {bad}")
    return {"command": native.build_command,
            "build_s": native.build_seconds, "jpeg": jpeg, "checks": checks,
            "letterbox_ms": letterbox_ms, "batch_build": builds}


JPEG_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures",
                           "torch_jpeg_corpus")
# the corpus's 640x480 scene, its coefficients recoded losslessly with
# arithmetic coding (sequential, progressive), and recoded with AC bands
# never refined (libjpeg smooths them), Huffman and arithmetic
SCENE = "scene_640x480.jpg"
ARITH_TWINS = ("scene_arith_640x480.jpg",
               "scene_arith_progressive_640x480.jpg")
UNREFINED = ("scene_unrefined_640x480.jpg",
             "scene_unrefined_arith_640x480.jpg")


def jpeg_corpus() -> dict:
    """9b: the corpus against the digests of the JAX package's libjpeg
    decode recorded in its digests.json (tests/torch_jpeg_corpus.py), and
    the scene's arithmetic twins against the scene's digest."""
    import hashlib

    from yolov5m_tpu_torch.data import native

    with open(os.path.join(JPEG_CORPUS, "digests.json")) as f:
        digests = json.load(f)
    wrong, refused = [], 0
    for name, want in sorted(digests.items()):
        with open(os.path.join(JPEG_CORPUS, name), "rb") as f:
            data = f.read()
        img = native.decode_jpeg(data)
        got = None if img is None else hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest()
        hw = native.jpeg_dims(data)
        refused += img is None
        if got != want["sha256"] or (
                None if hw is None else list(hw)) != want["hw"]:
            wrong.append({"file": name, "sha256": got, "want": want["sha256"],
                          "hw": hw, "want_hw": want["hw"]})
    twins = {}
    for name in ARITH_TWINS:
        with open(os.path.join(JPEG_CORPUS, name), "rb") as f:
            img = native.decode_jpeg(f.read())
        twins[name] = img is not None and hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest() == \
            digests[SCENE]["sha256"]
    res = {"files": len(digests), "equal": len(digests) - len(wrong),
           "none": refused, "wrong": wrong, "twins_equal_scene": twins}
    log(f"9b JPEG corpus: {res['equal']} of {res['files']} files decode to "
        f"the JAX package's libjpeg digest and header size ({refused} give "
        f"None, as there)")
    log(f"9b arithmetic twins decode to {SCENE}'s digest: "
        f"{json.dumps(twins)}")
    if wrong:
        raise AssertionError(f"9b: the decoder differs from libjpeg on "
                             f"{json.dumps(wrong)}")
    if not all(twins.values()):
        raise AssertionError(f"9b: an arithmetic twin of {SCENE} decodes "
                             f"to other pixels: {json.dumps(twins)}")
    return res


def arith_twins_detect(card: str, npz: str) -> dict:
    """9b: cli.detect --all over the scene and its arithmetic twins: the
    twins' detections equal the scene's, and the kernel launched."""
    import shutil

    from yolov5m_tpu_torch.cli import detect
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    names = (SCENE, *ARITH_TWINS)
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            shutil.copyfile(os.path.join(JPEG_CORPUS, name),
                            os.path.join(tmp, name))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", tmp, "--all", "--bs", str(P7["bs"]), "--nc", "80",
             "--weights", npz, "--fuse", "--device", "cuda"]))
        launches = nms_kernel.keep_launches
    res = {"launches": launches,
           "detections": {n: len(results[n]) for n in names},
           "equal_scene": {n: results[n] == results[SCENE]
                           for n in ARITH_TWINS}}
    log(f"9b detect --all over {SCENE} and its arithmetic twins: "
        f"{json.dumps(res)}, on {card}")
    if launches < 1:
        raise AssertionError("9b: detect over the arithmetic twins did not "
                             "launch the kernel")
    if not all(res["equal_scene"].values()) or not results[SCENE]:
        raise AssertionError(f"9b: the arithmetic twins' detections differ "
                             f"from {SCENE}'s, or it has none: "
                             f"{json.dumps(res)}")
    return res


def detect_dir_rate(opt, n: int, labels=tuple(range(80))) -> float:
    """images/s of cli.detect's directory loop over opt.img_dir (n images)
    on a built model: the median of 3 passes after a warmup, host decode
    and letterbox included."""
    from yolov5m_tpu_torch.cli import detect
    from yolov5m_tpu_torch.models.yolo import normalized_anchors

    model, cfg = detect.build_model(opt, 80, torch.device("cuda"))
    anchors = torch.from_numpy(normalized_anchors()).to("cuda")
    labels = list(labels)
    _quiet(detect._detect_dir, opt, model, anchors, cfg, labels,
           torch.device("cuda"))                           # warmup
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _quiet(detect._detect_dir, opt, model, anchors, cfg, labels,
               torch.device("cuda"))
        times.append(time.perf_counter() - t0)
    return n / statistics.median(times)


def jpeg_paths(card: str, npz: str, ppm_images_per_s: float) -> dict:
    """9b: the corpus, then the JPEG fixtures through the decode, detect
    and the server. ppm_images_per_s: 7e's detect rate over PPM files."""
    import concurrent.futures as cf
    import shutil

    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    corpus = jpeg_corpus()
    fx = jpeg_fixtures()
    names = [fx.name(i) for i in range(len(fx.SIZES))]
    paths = [os.path.join(fx.FOLDER, n) for n in names]
    mads = []
    for i, path in enumerate(paths):
        got, src = native.load_image_rgb(path), fx.scene(i)
        if got.shape != src.shape or native.read_image_size(path) != \
                src.shape[:2]:
            raise AssertionError(f"9b: {names[i]} decodes to {got.shape}, "
                                 f"its source is {src.shape}")
        mads.append(float(np.abs(got.astype(np.int16) - src).mean()))
    log(f"9b JPEG fixtures against their sources, mean absolute codes: "
        f"{json.dumps(dict(zip(names, mads)))}")
    if max(mads) > P9["max_jpeg_mad"]:
        raise AssertionError(f"9b: a JPEG fixture decodes {max(mads)} codes "
                             "from its source on average")
    datas = []
    for path in paths:
        with open(path, "rb") as f:
            datas.append(f.read())
    reps = P9["decode_reps"]
    decode_ms = {f"{w}x{h}": _median_ms(
        lambda d=datas[i]: native.decode_jpeg(d), reps)
        for i, (h, w) in enumerate(fx.SIZES[:2])}
    with cf.ThreadPoolExecutor(P9["pool_threads"]) as pool:
        six_ms = _median_ms(
            lambda: list(pool.map(native.decode_jpeg, datas)), reps)
    decode_ms[f"{len(datas)}_on_{P9['pool_threads']}_threads"] = six_ms
    log(f"9b JPEG decode ms (median of {reps}; one decode on one thread, "
        f"then the {len(datas)} fixtures at once on {P9['pool_threads']} "
        f"threads): {json.dumps(decode_ms)} on {card}")
    scene_ms = {}
    for name in (SCENE, *ARITH_TWINS, *UNREFINED):
        with open(os.path.join(JPEG_CORPUS, name), "rb") as f:
            data = f.read()
        scene_ms[name] = _median_ms(lambda d=data: native.decode_jpeg(d),
                                    reps)
        log(f"9b decode ms of {name} (median of {reps}, one decode on one "
            f"thread): {scene_ms[name]} on {card}")
    arith = arith_twins_detect(card, npz)

    bs = P7["bs"]
    args = ["--img_dir", fx.FOLDER, "--all", "--bs", str(bs), "--nc", "80",
            "--weights", npz, "--fuse", "--device", "cuda"]
    nms_kernel.keep_launches = 0
    results, _ = _quiet(detect.main, detect.arg_parser(args))
    detect_launches = nms_kernel.keep_launches
    plain, _ = _quiet(detect.main, detect.arg_parser(args),
                      nms_backend="torch")
    per_image = sum(len(results[n]) for n in names) / len(names)
    want = -(-len(names) // bs)

    # 7e's rate, over as many JPEG files as 7e's PPM directory holds: the
    # fixtures in turn, under 7e's arguments
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(P7["n_val"]):
            shutil.copyfile(paths[i % len(paths)],
                            os.path.join(tmp, f"img{i:02d}.jpg"))
        rate_opt = detect.arg_parser(
            ["--img_dir", tmp, "--all", "--bs", str(bs), "--nc", "80",
             "--weights", npz, "--model", P7["model"], "--first_out",
             str(P7["first_out"]), "--image_size", str(P7["size"]),
             "--device", "cuda"])
        jpeg_ips = detect_dir_rate(rate_opt, P7["n_val"])
    log(f"9b detect --all over {P7['n_val']} JPEG files: {jpeg_ips:.2f} "
        f"images/s against 7e's {ppm_images_per_s:.2f} over PPM files "
        f"(median of 3, host decode and letterbox included), on {card}")

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        nms_kernel.keep_launches = 0
        with DetectionClient(port=server.port) as c:
            for f in datas:                  # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in datas]
        serve_launches = nms_kernel.keep_launches
    finally:
        server.stop()
    served = [[(d["label"], d["confidence"], d["box"])
               for d in r.get("detections", [])] for r in replies]
    detected = [[(d["class"], round(d["conf"], 5),
                  [round(v, 2) for v in d["box_xyxy"]])
                 for d in results[n]] for n in names]
    res = {"jpeg": "built", "corpus": corpus, "mean_abs_codes": mads,
           "decode_ms": decode_ms, "scene_decode_ms": scene_ms,
           "arith_detect": arith, "detect_images_per_s": jpeg_ips,
           "ppm_detect_images_per_s": ppm_images_per_s,
           "detect_launches": detect_launches,
           "detections_per_image": per_image,
           "serve_launches": serve_launches,
           "served_detections": sum(len(s) for s in served)}
    log(f"9b detect --all and the server on {len(names)} JPEG files: "
        f"{json.dumps({k: v for k, v in res.items() if k != 'corpus'})}, "
        f"on {card}")
    if detect_launches != want:
        raise AssertionError(f"9b: detect launched the kernel "
                             f"{detect_launches} times, not {want}")
    if plain != results:
        raise AssertionError("9b: detect's results differ between the kernel "
                             "and the plain NMS")
    if per_image < P7["min_dets"]:
        raise AssertionError(f"9b: {per_image} detections an image")
    if not all(r.get("ok") for r in replies) or served != detected:
        raise AssertionError("9b: the server's replies differ from detect's "
                             "on the same JPEG files")
    if serve_launches < 1:
        raise AssertionError("9b: the server did not launch the kernel")
    return res


def compact_gate(card: str, p4: dict) -> dict:
    """9c and 9d: the compact gate against the sort gate on phase 4's
    frames, above capacity against its CPU run, and gate_density."""
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops import postprocess
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.nms import NEG_INF, suppress
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    model, frames = p4["model"], p4["frames"]
    cfg = Config()
    k = cfg.topk_for_conf(0.25)
    kw = dict(conf_threshold=0.25, iou_threshold=cfg.nms_iou_thresh,
              max_detections=cfg.max_detections, pre_nms_topk=k)
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    with torch.inference_mode():
        preds = [model(normalize_uint8(f, torch.bfloat16)) for f in frames]
        nms_kernel.keep_launches = 0
        density = [postprocess.gate_density(p, anchors, **kw) for p in preds]
        density_launches = nms_kernel.keep_launches
        nms_kernel.keep_launches = 0
        compact = [postprocess.fused_detect(p, anchors, gate="compact", **kw)
                   for p in preds]
        compact_launches = nms_kernel.keep_launches
        sort = [postprocess.fused_detect(p, anchors, gate="sort", **kw)
                for p in preds]
        most = max(int(s.max()) for s, _ in density)
        equal = all(torch.equal(c[0], s[0]) and torch.equal(c[1], s[1])
                    for c, s in zip(compact, sort))
        survivors, dets = density[0]

        # the kernel's bound on the compact gate's NMS input
        boxes, cls, _, cvalid = postprocess.candidates(
            preds[0], anchors, (8, 16, 32), 0.25, k, gate="compact")
        bound = keep_bound_ms(cvalid, suppress(
            boxes, cls, cvalid, kw["iou_threshold"], backend="torch"))
        stage = {g: cuda_ms(lambda g=g: postprocess.candidates(
            preds[0], anchors, (8, 16, 32), 0.25, k, gate=g), 10)
            for g in ("sort", "compact")}
        times = {"sort": [], "compact": []}
        for r in range(2 + P9["gate_rounds"]):
            for g in (("sort", "compact") if r % 2 else ("compact", "sort")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                postprocess.fused_detect(model(normalize_uint8(
                    frames[r % len(frames)], torch.bfloat16)), anchors,
                    gate=g, **kw)[1].sum().item()
                if r >= 2:
                    times[g].append(time.perf_counter() - t0)
        ips = {g: frames[0].shape[0] / statistics.median(t)
               for g, t in times.items()}

        # above capacity: K 512 at the low gate, the first images of a batch
        low = dict(kw, conf_threshold=P9["low_conf"])
        sub = [p[:P9["cpu_images"]] for p in preds[0]]
        thresh = float(np.log(P9["low_conf"] / (1 - P9["low_conf"])))
        obj = torch.cat([p[..., 4].reshape(p.shape[0], -1).float()
                         for p in sub], 1)
        gated = torch.where(obj > thresh, obj, torch.full_like(obj, NEG_INF))
        low_survivors = (obj > thresh).sum(1)
        gate_card = postprocess._gate_compact(gated, k)
        gate_cpu = postprocess._gate_compact(gated.cpu(), k)
        gate_equal = all(torch.equal(a.cpu(), b)
                         for a, b in zip(gate_card, gate_cpu))
        out, valid = postprocess.fused_detect(sub, anchors, gate="compact",
                                              **low)
        out_cpu, valid_cpu = postprocess.fused_detect(
            [p.cpu() for p in sub], anchors.cpu(), gate="compact",
            backend="torch", **low)
        low_equal = (torch.equal(valid.cpu(), valid_cpu)
                     and torch.equal(out[..., 0].cpu(), out_cpu[..., 0]))
        low_err = float((out.cpu() - out_cpu).abs().max())
    res = {"K": k, "most_survivors": most, "bitwise_equal": equal,
           "compact_gate_launches": compact_launches,
           "kernel_bound_ms": bound[0], "kernel_bound_by": bound[1],
           "gate_topk_decode_ms": stage, "images_per_s": ips,
           "above_capacity": {
               "conf": P9["low_conf"], "images": P9["cpu_images"],
               "survivors_min": int(low_survivors.min()),
               "survivors_max": int(low_survivors.max()),
               "gate_equal_cpu": gate_equal, "detections_equal_cpu":
               low_equal, "max_abs_err": low_err}}
    log(f"9c compact gate at bs {frames[0].shape[0]}, 640: {json.dumps(res)}"
        f" on {card}")
    dens = {"gate_density_launches": density_launches,
            "survivors_per_image": float(survivors.float().mean()),
            "detections_per_image": float(dets.float().mean()),
            "equal_phase4": torch.equal(dets.cpu(), p4["valid_counts"])}
    log(f"9d gate_density over {frames[0].shape[0]} frames: "
        f"{json.dumps(dens)}")
    if most > k:
        raise AssertionError(f"9c: {most} survivors in an image exceed K {k}:"
                             " the bitwise check needs them to fit")
    if not equal:
        raise AssertionError("9c: the compact gate differs from the sort gate"
                             " below capacity")
    if compact_launches != len(frames) or density_launches != len(frames):
        raise AssertionError(f"9c/9d: {compact_launches} and "
                             f"{density_launches} launches for "
                             f"{len(frames)} batches")
    if int(low_survivors.max()) <= k or not gate_equal or not low_equal \
            or low_err > 1e-3:
        raise AssertionError("9c: above capacity the compact gate on the card"
                             " differs from its CPU run: " +
                             json.dumps(res["above_capacity"]))
    if not dens["equal_phase4"]:
        raise AssertionError("9d: gate_density's detections differ from "
                             "phase 4's valid counts")
    return {**res, "density": dens}


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def export_phase(card: str, flagship: dict, stripped: dict,
                 frames) -> dict:
    """9e: ONNX and torch.export of the flagship, and the stripped
    checkpoint in detect."""
    from yolov5m_tpu_torch.cli import detect
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops.decode import decode_predictions
    from yolov5m_tpu_torch.ops.nms import batched_nms
    from yolov5m_tpu_torch.utils import export
    from yolov5m_tpu_torch.utils.onnx_export import export_onnx
    from yolov5m_tpu_torch.utils.onnx_proto import summarize_model

    rtol = P9["export_rtol"]
    with tempfile.TemporaryDirectory() as tmp:
        path = export_onnx({k: v.cpu() for k, v in flagship.items()},
                           os.path.join(tmp, "flagship.onnx"))
        with open(path, "rb") as f:
            ops = [o for o, _ in summarize_model(f.read())["ops"]]
        counts = {o: ops.count(o) for o in sorted(set(ops))}
        onnx_mib = os.path.getsize(path) / 2 ** 20

        model = YOLOv5(first_out=P7["first_out"], nc=80,
                       depth_mult=P7["depth"])
        model.load_state_dict(flagship, strict=True)
        model = model.cuda().eval()
        x = frames[0][:1].float() / 255.0
        t0 = time.perf_counter()
        prog = export.load_program(export.export_program(
            model, os.path.join(tmp, "forward.pt2")))
        forward_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prog_pp = export.load_program(export.export_program(
            model, os.path.join(tmp, "postprocess.pt2"),
            with_postprocess=True))
        postprocess_s = time.perf_counter() - t0
        anchors = torch.from_numpy(normalized_anchors()).cuda()
        with torch.no_grad():
            eager = model(x)
            got = prog(x)
            out, valid = prog_pp(x)
            want_out, want_valid = batched_nms(
                decode_predictions(eager, anchors), 0.45, 0.25, 300, 1024,
                backend="torch")
        forward_err = max(_rel_err(g, w) for g, w in zip(got, eager))
        pp_equal = (torch.equal(valid, want_valid)
                    and torch.equal(out[..., 0], want_out[..., 0]))
        pp_err = _rel_err(out, want_out)

        ckpt = os.path.join(tmp, "stripped.pt")
        torch.save(stripped, ckpt)
        loaded, _ = detect.build_model(detect.arg_parser(
            ["--checkpoint", ckpt, "--nc", "80", "--device", "cuda"]), 80,
            torch.device("cuda"))
        n_params = export.count_parameters(loaded)
        res = {"onnx_counts": counts, "onnx_mib": onnx_mib,
               "program_s": {"forward": forward_s,
                             "postprocess": postprocess_s},
               "forward_rel_err": forward_err,
               "postprocess_equal": pp_equal, "postprocess_rel_err": pp_err,
               "program_detections": int(valid.sum()),
               "stripped_mib": os.path.getsize(ckpt) / 2 ** 20,
               "count_parameters": n_params,
               "model_size_mb": export.model_size_mb(loaded)}
    log(f"9e export of the flagship: {json.dumps(res)} on {card}")
    if counts != ONNX_COUNTS:
        raise AssertionError(f"9e: ONNX node counts {counts}")
    if forward_err > rtol or pp_err > rtol or not pp_equal:
        raise AssertionError("9e: a torch.export program differs from eager")
    if n_params != JAX_FLAGSHIP_PARAMETERS:
        raise AssertionError(f"9e: {n_params} parameters, JAX counts "
                             f"{JAX_FLAGSHIP_PARAMETERS}")
    return res


def traced_batch(card: str, p4: dict, label: str = "9f trace of one "
                 "main-path batch") -> dict:
    """9f: torch.profiler around one main-path batch at bs 128 (10c: the
    int8 chain's)."""
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
    from yolov5m_tpu_torch.utils.misc import TRACE_FILE, profile_trace

    cfg = Config()
    kw = dict(conf_threshold=0.25, iou_threshold=cfg.nms_iou_thresh,
              max_detections=cfg.max_detections,
              pre_nms_topk=cfg.topk_for_conf(0.25))
    model, x = p4["model"], p4["frames"][0]
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with torch.inference_mode(), profile_trace(tmp):
            fused_detect(model(normalize_uint8(x, torch.bfloat16)), anchors,
                         **kw)[1].sum().item()
        top, idle, window = trace_summary(os.path.join(tmp, TRACE_FILE))
    if not top:
        raise AssertionError("9f: the trace holds no device event (the "
                             "profiler saw no kernel)")
    res = {"window_ms": window, "idle_share": idle,
           "top_device_ops_ms": top}
    log(f"{label} at bs {x.shape[0]}: {json.dumps(res)} on {card}")
    return res


PNG_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures", "torch_png_corpus")


def host_ops(card: str) -> dict:
    """9g: the host augmentation's C ops against the digests of cv2's
    outputs, the PNG corpus against Pillow's, and one call of each timed."""
    import hashlib
    import zlib

    from yolov5m_tpu_torch.data import augment, native

    cases = tests_module("torch_cv_ops_cases")
    want = cases.load()
    ops = cases.port_cases()
    wrong = sorted(name for name in set(want) | set(ops)
                   if name not in ops or cases.digest(ops[name]()) !=
                   want.get(name))
    log(f"9g C ops (csrc/augment.cc): {len(ops) - len(wrong)} of "
        f"{len(want)} cases give the sha256 of cv2's output (zlib "
        f"{zlib.ZLIB_VERSION} for PNG)")

    with open(os.path.join(PNG_CORPUS, "digests.json")) as f:
        digests = json.load(f)
    png_wrong, refused = [], 0
    for name, ref in sorted(digests.items()):
        with open(os.path.join(PNG_CORPUS, name), "rb") as f:
            data = f.read()
        img, hw = native.decode_png(data), native.png_dims(data)
        got = {"sha256": None if img is None else hashlib.sha256(
                   np.ascontiguousarray(img).tobytes()).hexdigest(),
               "hw": None if hw is None else list(hw)}
        refused += img is None
        if got != ref:
            png_wrong.append({"file": name, "got": got, "want": ref})
    log(f"9g PNG corpus: {len(digests) - len(png_wrong)} of {len(digests)} "
        f"files decode to Pillow's digest and header size ({refused} "
        f"refused, as there)")

    reps = P9["op_reps"]
    img = cases.image(640, 640, 640)
    canvas = cases.image(8, 1280, 1280)
    m = augment.rotation_matrix((320.0, 320.0), 13.25)
    gains = np.asarray(cases.HSV_GAINS)
    with open(os.path.join(PNG_CORPUS, "scene_640x480.png"), "rb") as f:
        scene = f.read()
    ms = {"rotate": _median_ms(
              lambda: native.warp_affine(img, m, (640, 640)), reps),
          "blur_k7": _median_ms(lambda: native.box_blur(img, 7), reps),
          "clahe": _median_ms(
              lambda: augment.TrainAugment._clahe(img), reps),
          "hsv": _median_ms(
              lambda: augment.augment_hsv(img, None, gains=gains), reps),
          "downscale": _median_ms(lambda: native.downscale2x(canvas), reps),
          "png_decode_640x480": _median_ms(
              lambda: native.decode_png(scene), reps)}
    log(f"9g one 640x640 call of each op (the downscale from 1280) and one "
        f"640x480 PNG decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")
    if wrong:
        raise AssertionError(f"9g: the C ops differ from cv2's digests on "
                             f"{wrong}")
    if png_wrong:
        raise AssertionError(f"9g: the PNG decoder differs from Pillow on "
                             f"{json.dumps(png_wrong)}")
    return {"op_cases": len(want), "png_files": len(digests),
            "png_refused": refused, "ms": ms}


def plot_fixtures(card: str) -> dict:
    """9h: every case of tests/torch_plot_cases.py rendered by the port,
    its decoded RGBA against the digest of the JAX package's image; one
    plot_image and one save_prediction_images at 640x480 timed."""
    from yolov5m_tpu_torch.utils import plotting

    cases = tests_module("torch_plot_cases")
    with open(cases.DIGESTS) as f:
        want = json.load(f)
    wrong, equal, files = [], 0, 0
    with tempfile.TemporaryDirectory() as folder:
        for name, case in sorted(cases.cases().items()):
            got = [{"sha256": cases.rgba_digest(cases.decode(p)),
                    "shape": list(cases.decode(p).shape)}
                   for p in cases.run(plotting, name, case, folder)]
            files += len(got)
            if got == want.get(name):
                equal += len(got)
            else:
                wrong.append({"case": name, "got": got,
                              "want": want.get(name)})
        img = cases.image(3, 480, 640)
        rows = cases.rows(3, 20, 480, 640)
        path = os.path.join(folder, "t.png")
        reps = P9["plot_reps"]
        ms = {"plot_image_640x480": _median_ms(
                  lambda: plotting.plot_image(img, rows, save_path=path),
                  reps),
              "save_prediction_images_640x480": _median_ms(
                  lambda: plotting.save_prediction_images(
                      img[None], [rows], [rows[:5]], folder, "t", 0,
                      num_images=1), reps)}
    missing = sorted(set(want) - set(cases.cases()))
    log(f"9h prediction images (csrc/plot.cc): {equal} of {files} files of "
        f"{len(want)} cases give the sha256 of the JAX package's image; "
        f"one call, ms (median of {reps}, 20 boxes, the PNG written): "
        f"{json.dumps(ms)} on {card}")
    if wrong or missing or equal != sum(len(v) for v in want.values()):
        raise AssertionError(f"9h: the port's images differ from the JAX "
                             f"package's digests: {json.dumps(wrong)} "
                             f"{missing}")
    return {"cases": len(want), "files": files, "equal": equal, "ms": ms}


PILLOW_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures",
                             "torch_pillow_corpus")
# 9i: the corpus's 640x480 scenes served and run through detect --all (the
# BMP and GIF named .jpg, as a loader meets them); the unrefined scene
# through detect --img
PILLOW_SCENES = ("scene_cmyk_640x480.jpg", "scene_ycck_640x480.jpg",
                 "scene_lossless_640x480.jpg", "scene_640x480.bmp",
                 "scene_640x480.gif")
PILLOW_SERVED = ("scene_cmyk_640x480.jpg", "scene_ycck_640x480.jpg",
                 "scene_640x480.bmp", "scene_640x480.gif")
PILLOW_IMG = "smooth_scene_unrefined_640x480.jpg"


def _printed_detections(out: str) -> list:
    """The detection lines cli.detect prints for --img."""
    return [line for line in out.splitlines() if line.startswith("  ")]


def corpus_routes(folder: str) -> tuple:
    """Every file of a decode corpus on both JAX routes: the sha256 of
    decode_image (the server, the loader) and of load_image_pillow (detect
    --img), and read_image_size, against its digests.json. Returns
    (digests, the files that differ, how many files are refused)."""
    import hashlib

    from yolov5m_tpu_torch.data import native

    def sha(img):
        return None if img is None else hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest()

    def attempt(fn, *args):
        try:
            return fn(*args)
        except ValueError:
            return None

    with open(os.path.join(folder, "digests.json")) as f:
        digests = json.load(f)
    wrong = []
    for name, want in sorted(digests.items()):
        path = os.path.join(folder, name)
        with open(path, "rb") as f:
            data = f.read()
        hw = attempt(native.read_image_size, path)
        got = {"loader": sha(native.decode_image(data)),
               "img": sha(attempt(native.load_image_pillow, path)),
               "hw": None if hw is None else list(hw)}
        if got != want:
            wrong.append({"file": name, "got": got, "want": want})
    return digests, wrong, sum(v["img"] is None for v in digests.values())


def pillow_route(card: str, npz: str) -> dict:
    """9i: the decodes the JAX package leaves to Pillow (CMYK, YCCK and
    lossless JPEG, libjpeg-turbo 3.1.3's smoothing and refusals for detect
    --img, BMP, GIF) in the port's own C: every file of the corpus against
    the digests of both JAX routes and the size Pillow reads; one decode of
    each 640x480 scene timed; the server and detect on the scenes against
    the same runs on their decoded pixels written as PPM, the kernel
    launched."""
    import shutil

    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    digests, wrong, refused = corpus_routes(PILLOW_CORPUS)
    log(f"9i Pillow-route corpus: {len(digests) - len(wrong)} of "
        f"{len(digests)} files give both JAX routes' digests (the loader's "
        f"libjpeg-turbo 2.1 or Pillow, detect --img's Pillow over "
        f"libjpeg-turbo 3.1.3) and Pillow's size ({refused} refused, as "
        f"there)")
    if wrong:
        raise AssertionError(f"9i: the port differs from the JAX routes on "
                             f"{json.dumps(wrong)}")

    reps = P9["decode_reps"]
    datas = {}
    for name in (*PILLOW_SCENES, PILLOW_IMG):
        with open(os.path.join(PILLOW_CORPUS, name), "rb") as f:
            datas[name] = f.read()
    ms = {name: _median_ms(lambda d=datas[name]: native.decode_image(d), reps)
          for name in PILLOW_SCENES}
    ms[PILLOW_IMG + " (detect --img's route)"] = _median_ms(
        lambda: native.decode_jpeg_pillow(datas[PILLOW_IMG]), reps)
    ms[PILLOW_IMG + " (the loader's route)"] = _median_ms(
        lambda: native.decode_jpeg(datas[PILLOW_IMG]), reps)
    log(f"9i one 640x480 decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")

    bs = P7["bs"]
    common = ["--nc", "80", "--weights", npz, "--fuse", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        mixed, twins = os.path.join(tmp, "mixed"), os.path.join(tmp, "ppm")
        os.makedirs(mixed)
        os.makedirs(twins)
        for i, name in enumerate(PILLOW_SCENES):
            shutil.copyfile(os.path.join(PILLOW_CORPUS, name),
                            os.path.join(mixed, f"img{i}.jpg"))
            with open(os.path.join(twins, f"img{i}.ppm"), "wb") as f:
                f.write(native.encode_ppm(native.decode_image(
                    datas[name])))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", mixed, "--all", "--bs", str(bs), *common]))
        detect_launches = nms_kernel.keep_launches
        ppm_results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", twins, "--all", "--bs", str(bs), *common]))
        same_all = {k.replace(".ppm", ".jpg"): v
                    for k, v in ppm_results.items()} == results
        img_ppm = os.path.join(tmp, "unrefined.ppm")
        with open(img_ppm, "wb") as f:
            f.write(native.encode_ppm(native.decode_jpeg_pillow(
                datas[PILLOW_IMG])))
        nms_kernel.keep_launches = 0
        _, out = _quiet(detect.main, detect.arg_parser(
            ["--img", os.path.join(PILLOW_CORPUS, PILLOW_IMG), *common]))
        img_launches = nms_kernel.keep_launches
        _, ppm_out = _quiet(detect.main, detect.arg_parser(
            ["--img", img_ppm, *common]))
        img_rows = _printed_detections(out)
        same_img = img_rows == _printed_detections(ppm_out)

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        frames = [datas[n] for n in PILLOW_SERVED]
        twin_frames = [native.encode_ppm(native.decode_image(d))
                       for d in frames]
        with DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in frames:                 # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in frames]
            serve_launches = nms_kernel.keep_launches
            for f in twin_frames:
                c.send(f)
            twin_replies = [c.recv() for _ in twin_frames]
    finally:
        server.stop()
    res = {"files": len(digests), "refused": refused, "decode_ms": ms,
           "detect_launches": detect_launches,
           "detections": {n: len(results[f"img{i}.jpg"])
                          for i, n in enumerate(PILLOW_SCENES)},
           "detect_equals_ppm": same_all, "img_launches": img_launches,
           "img_detections": len(img_rows), "img_equals_ppm": same_img,
           "serve_launches": serve_launches,
           "served_detections": {n: len(r.get("detections", []))
                                 for n, r in zip(PILLOW_SERVED, replies)},
           "serve_equals_ppm": replies == twin_replies}
    log(f"9i detect --all over the five scenes (BMP and GIF named .jpg), "
        f"detect --img on {PILLOW_IMG} and the server on the CMYK, YCCK, BMP "
        f"and GIF scenes: {json.dumps(res)}, on {card}")
    if not (same_all and same_img and res["serve_equals_ppm"]):
        raise AssertionError(f"9i: detections on the decoded files differ "
                             f"from those on their PPM twins: "
                             f"{json.dumps(res)}")
    if not all(r.get("ok") for r in replies):
        raise AssertionError(f"9i: the server refused a frame: {replies}")
    if detect_launches != -(-len(PILLOW_SCENES) // bs) or img_launches != 1 \
            or serve_launches < 1:
        raise AssertionError(f"9i: the kernel's launches: {json.dumps(res)}")
    if not all(res["detections"].values()) or not img_rows:
        raise AssertionError(f"9i: a scene without detections: "
                             f"{json.dumps(res)}")
    return res


WEBP_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures",
                           "torch_webp_corpus")
# 9j: the corpus's 640x480 scenes, served and run through detect --all (named
# .jpg, as a loader meets them: the listing, as JAX's, takes no .webp); the
# lossy one through detect --img; the rate directories hold the scenes in
# turn
WEBP_SCENES = ("scene_lossy_640x480.webp", "scene_lossless_640x480.webp",
               "scene_alpha_640x480.webp")
P9J = {"rate_files": 24}


def webp_route(card: str, npz: str) -> dict:
    """9j: WebP in the port's own C, as Pillow decodes it over libwebp
    1.6.0: every file of the corpus against the digests of both JAX routes
    and the size Pillow reads; one decode of each 640x480 scene timed; the
    server and detect on the scenes against the same runs on their decoded
    pixels written as PPM, the kernel launched; detect's rate over WebP
    files against PPM files of the same pixels."""
    import shutil

    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    digests, wrong, refused = corpus_routes(WEBP_CORPUS)
    log(f"9j WebP corpus: {len(digests) - len(wrong)} of {len(digests)} "
        f"files give both JAX routes' digests (Pillow over libwebp 1.6.0) "
        f"and Pillow's size ({refused} refused, as there)")
    if wrong:
        raise AssertionError(f"9j: the port differs from the JAX routes on "
                             f"{json.dumps(wrong)}")

    reps = P9["decode_reps"]
    datas = {}
    for name in WEBP_SCENES:
        with open(os.path.join(WEBP_CORPUS, name), "rb") as f:
            datas[name] = f.read()
    ms = {name: _median_ms(lambda d=datas[name]: native.decode_image(d), reps)
          for name in WEBP_SCENES}
    log(f"9j one 640x480 decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")

    bs = P7["bs"]
    common = ["--nc", "80", "--weights", npz, "--fuse", "--device", "cuda"]
    pixels = {n: native.decode_image(d) for n, d in datas.items()}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k)
                for k in ("named_jpg", "ppm", "rate_webp", "rate_ppm")}
        for d in dirs.values():
            os.makedirs(d)
        for i, name in enumerate(WEBP_SCENES):
            shutil.copyfile(os.path.join(WEBP_CORPUS, name),
                            os.path.join(dirs["named_jpg"], f"img{i}.jpg"))
            with open(os.path.join(dirs["ppm"], f"img{i}.ppm"), "wb") as f:
                f.write(native.encode_ppm(pixels[name]))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["named_jpg"], "--all", "--bs", str(bs),
             *common]))
        detect_launches = nms_kernel.keep_launches
        ppm_results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["ppm"], "--all", "--bs", str(bs), *common]))
        same_all = {k.replace(".ppm", ".jpg"): v
                    for k, v in ppm_results.items()} == results
        nms_kernel.keep_launches = 0
        _, out = _quiet(detect.main, detect.arg_parser(
            ["--img", os.path.join(WEBP_CORPUS, WEBP_SCENES[0]), *common]))
        img_launches = nms_kernel.keep_launches
        _, ppm_out = _quiet(detect.main, detect.arg_parser(
            ["--img", os.path.join(dirs["ppm"], "img0.ppm"), *common]))
        img_rows = _printed_detections(out)
        same_img = img_rows == _printed_detections(ppm_out)

        # detect's directory loop over WebP files and over PPM files of the
        # same pixels, under 7e's arguments, in turns
        n = P9J["rate_files"]
        for i in range(n):
            name = WEBP_SCENES[i % len(WEBP_SCENES)]
            shutil.copyfile(os.path.join(WEBP_CORPUS, name),      # as .jpg
                            os.path.join(dirs["rate_webp"], f"img{i:02d}.jpg"))
            with open(os.path.join(dirs["rate_ppm"], f"img{i:02d}.ppm"),
                      "wb") as f:
                f.write(native.encode_ppm(pixels[name]))
        rates = {"webp": [], "ppm": []}
        for _ in range(2):
            for kind in ("webp", "ppm"):
                rates[kind].append(detect_dir_rate(detect.arg_parser(
                    ["--img_dir", dirs["rate_" + kind], "--all", "--bs",
                     str(bs), "--nc", "80", "--weights", npz, "--model",
                     P7["model"], "--first_out", str(P7["first_out"]),
                     "--image_size", str(P7["size"]), "--device", "cuda"]),
                    n))
    log(f"9j detect --all over {n} WebP files named .jpg (the three scenes "
        f"in turn): "
        f"{json.dumps(rates['webp'])} images/s against "
        f"{json.dumps(rates['ppm'])} over PPM files of the same pixels "
        f"(each the median of 3 passes, the two in turns, host decode and "
        f"letterbox included), on {card}")

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        frames = [datas[n] for n in WEBP_SCENES]
        twin_frames = [native.encode_ppm(pixels[n]) for n in WEBP_SCENES]
        with DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in frames:                 # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in frames]
            serve_launches = nms_kernel.keep_launches
            for f in twin_frames:
                c.send(f)
            twin_replies = [c.recv() for _ in twin_frames]
    finally:
        server.stop()
    res = {"files": len(digests), "refused": refused, "decode_ms": ms,
           "detect_launches": detect_launches,
           "detections": {n: len(results[f"img{i}.jpg"])
                          for i, n in enumerate(WEBP_SCENES)},
           "detect_equals_ppm": same_all, "img_launches": img_launches,
           "img_detections": len(img_rows), "img_equals_ppm": same_img,
           "serve_launches": serve_launches,
           "served_detections": {n: len(r.get("detections", []))
                                 for n, r in zip(WEBP_SCENES, replies)},
           "serve_equals_ppm": replies == twin_replies,
           "detect_images_per_s": {k: statistics.median(v)
                                   for k, v in rates.items()}}
    log(f"9j detect --all over the three scenes (named .jpg), detect --img "
        f"on {WEBP_SCENES[0]} and the server on the three: "
        f"{json.dumps(res)}, on {card}")
    if not (same_all and same_img and res["serve_equals_ppm"]):
        raise AssertionError(f"9j: detections on the decoded files differ "
                             f"from those on their PPM twins: "
                             f"{json.dumps(res)}")
    if not all(r.get("ok") for r in replies):
        raise AssertionError(f"9j: the server refused a frame: {replies}")
    if detect_launches != -(-len(WEBP_SCENES) // bs) or img_launches != 1 \
            or serve_launches < 1:
        raise AssertionError(f"9j: the kernel's launches: {json.dumps(res)}")
    if not all(res["detections"].values()) or not img_rows:
        raise AssertionError(f"9j: a scene without detections: "
                             f"{json.dumps(res)}")
    return res


PNM_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures", "torch_pnm_corpus")
# 9k: the scene as every PNM route reads it, made here from its seed
# (tests/torch_pnm_corpus.py:scene_cases); --img on the plain P3; the rate
# directories hold plain P3 files of the scene and their P6 twins
PNM_IMG = "scene_p3_640x480.ppm"
P9K = {"rate_files": 24}


def pnm_route(card: str, npz: str) -> dict:
    """9k: PNM as Pillow's PpmImagePlugin reads it, in the port's own code
    (data/pnm.py, csrc/pnm_decode.cc): every file of the corpus and the six
    640x480 scenes against the digests of both JAX routes and the size
    Pillow reads; one decode of each scene timed; the server and detect on
    the scenes against the same runs on P6 twins of their pixels, the
    kernel launched; detect's rate over plain P3 files against their P6
    twins, in turns."""
    import hashlib

    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    digests, wrong, refused = corpus_routes(PNM_CORPUS)
    scenes = tests_module("torch_pnm_corpus").scene_cases(
        jpeg_fixtures().scene(0))
    with open(os.path.join(PNM_CORPUS, "scene_digests.json")) as f:
        scene_digests = json.load(f)
    pixels = {n: native.decode_image(d) for n, d in scenes.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in scenes.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            shas = {hashlib.sha256(np.ascontiguousarray(img).tobytes())
                    .hexdigest() for img in (pixels[name],
                                             native.load_image_pillow(path))}
            got = {"img": shas.pop() if len(shas) == 1 else None,
                   "hw": list(native.read_image_size(path))}
            want = scene_digests[name]
            if got != {"img": want["img"], "hw": want["hw"]}:
                wrong.append({"file": name, "got": got, "want": want})
    log(f"9k PNM corpus: {len(digests) - len(wrong)} of {len(digests)} "
        f"files and the {len(scenes)} scenes give both JAX routes' digests "
        f"(Pillow's PpmImagePlugin) and Pillow's size ({refused} refused, "
        f"as there)")
    if wrong:
        raise AssertionError(f"9k: the port differs from the JAX routes on "
                             f"{json.dumps(wrong)}")

    reps = P9["decode_reps"]
    ms = {name: _median_ms(lambda d=data: native.decode_image(d), reps)
          for name, data in scenes.items()}
    log(f"9k one 640x480 decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")

    bs = P7["bs"]
    common = ["--nc", "80", "--weights", npz, "--fuse", "--device", "cuda"]
    names = sorted(scenes)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k)
                for k in ("pnm", "twins", "rate_p3", "rate_p6")}
        for d in dirs.values():
            os.makedirs(d)
        for i, name in enumerate(names):
            with open(os.path.join(dirs["pnm"], f"img{i}.ppm"), "wb") as f:
                f.write(scenes[name])
            with open(os.path.join(dirs["twins"], f"img{i}.ppm"), "wb") as f:
                f.write(native.encode_ppm(pixels[name]))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["pnm"], "--all", "--bs", str(bs), *common]))
        detect_launches = nms_kernel.keep_launches
        twin_results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["twins"], "--all", "--bs", str(bs),
             *common]))
        same_all = twin_results == results
        img = os.path.join(dirs["pnm"], f"img{names.index(PNM_IMG)}.ppm")
        nms_kernel.keep_launches = 0
        _, out = _quiet(detect.main, detect.arg_parser(["--img", img,
                                                        *common]))
        img_launches = nms_kernel.keep_launches
        _, twin_out = _quiet(detect.main, detect.arg_parser(
            ["--img", img.replace(dirs["pnm"], dirs["twins"]), *common]))
        img_rows = _printed_detections(out)
        same_img = img_rows == _printed_detections(twin_out)

        # detect's directory loop over plain P3 files and over their P6
        # twins, under 7e's arguments, in turns
        n = P9K["rate_files"]
        for i in range(n):
            with open(os.path.join(dirs["rate_p3"], f"img{i:02d}.ppm"),
                      "wb") as f:
                f.write(scenes[PNM_IMG])
            with open(os.path.join(dirs["rate_p6"], f"img{i:02d}.ppm"),
                      "wb") as f:
                f.write(native.encode_ppm(pixels[PNM_IMG]))
        rates = {"p3": [], "p6": []}
        for _ in range(2):
            for kind in ("p3", "p6"):
                rates[kind].append(detect_dir_rate(detect.arg_parser(
                    ["--img_dir", dirs["rate_" + kind], "--all", "--bs",
                     str(bs), "--nc", "80", "--weights", npz, "--model",
                     P7["model"], "--first_out", str(P7["first_out"]),
                     "--image_size", str(P7["size"]), "--device", "cuda"]),
                    n))
    log(f"9k detect --all over {n} plain P3 files of the scene: "
        f"{json.dumps(rates['p3'])} images/s against "
        f"{json.dumps(rates['p6'])} over their P6 twins (each the median of "
        f"3 passes, the two in turns, host decode and letterbox included), "
        f"on {card}")

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        frames = [scenes[n] for n in names]
        twin_frames = [native.encode_ppm(pixels[n]) for n in names]
        with DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in frames:                 # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in frames]
            serve_launches = nms_kernel.keep_launches
            for f in twin_frames:
                c.send(f)
            twin_replies = [c.recv() for _ in twin_frames]
    finally:
        server.stop()
    res = {"files": len(digests), "scenes": len(scenes), "refused": refused,
           "decode_ms": ms, "detect_launches": detect_launches,
           "detections": {n: len(results[f"img{i}.ppm"])
                          for i, n in enumerate(names)},
           "detect_equals_p6": same_all, "img_launches": img_launches,
           "img_detections": len(img_rows), "img_equals_p6": same_img,
           "serve_launches": serve_launches,
           "served_detections": {n: len(r.get("detections", []))
                                 for n, r in zip(names, replies)},
           "serve_equals_p6": replies == twin_replies,
           "detect_images_per_s": {k: statistics.median(v)
                                   for k, v in rates.items()}}
    log(f"9k detect --all over the six scenes, detect --img on {PNM_IMG} "
        f"and the server on the six: {json.dumps(res)}, on {card}")
    if not (same_all and same_img and res["serve_equals_p6"]):
        raise AssertionError(f"9k: detections on the PNM scenes differ from "
                             f"those on their P6 twins: {json.dumps(res)}")
    if not all(r.get("ok") for r in replies):
        raise AssertionError(f"9k: the server refused a frame: {replies}")
    if detect_launches != -(-len(names) // bs) or img_launches != 1 \
            or serve_launches < 1:
        raise AssertionError(f"9k: the kernel's launches: {json.dumps(res)}")
    if not all(res["detections"].values()) or not img_rows:
        raise AssertionError(f"9k: a scene without detections: "
                             f"{json.dumps(res)}")
    return res


TIFF_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures",
                           "torch_tiff_corpus")
# 9l: the scene as TIFF, made here from its seed
# (tests/torch_tiff_corpus.py:scene_cases); --img on an LZW file of it
# under Orientation 6; the rate directories hold LZW files of the scene
# and their PPM twins
TIFF_RATE = "scene_lzw_640x480.tif"
P9L = {"rate_files": 24, "decode_reps": 5}


@contextlib.contextmanager
def pil_blocked():
    """PIL unimportable for the block (the port must not need it); blocks
    nest, each restoring what it found."""
    absent = object()
    saved = {k: sys.modules.get(k, absent) for k in ("PIL", "PIL.Image")}
    sys.modules.update({"PIL": None, "PIL.Image": None})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is absent:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def left_to_pil(data: bytes) -> str | None:
    """Why the port leaves the file to PIL, or None where it does not:
    "plugin" where Pillow's open picks a plugin the port does not read
    (data/formats.py), "codec" where the TIFF's tags or the JPEG 2000's
    markers name what the port leaves to others; never a failed decode."""
    from yolov5m_tpu_torch.data import formats, jpeg2k, tiff

    picked = formats.pick(data)
    if picked is None or picked.refused:
        return None
    if picked.opened is None and \
            picked.name not in formats.SIGNATURE_FORMATS:
        return "plugin"
    route = {"TIFF": tiff.route, "JPEG2000": jpeg2k.route}.get(picked.name)
    if route is not None and route(picked.opened, data) is None:
        return "codec"
    return None


def tiff_corpus_routes(corpus, prefixes=None) -> tuple:
    """Every file of a decoder's corpus (prefixes: those whose names start
    with one of them) on every route against its
    digests.json: decode_image of the bytes (the server), load_image_rgb
    and load_image_pillow of the path (the loader, detect --img; Pillow
    maps a single uncompressed TIFF strip opened by path) and
    read_image_size. PIL is blocked for the check, so a file whose tags or
    markers the port leaves to PIL is refused, with its size read, whether
    or not the machine has PIL. Returns (digests, the files that differ,
    how many are refused, the names of the files left to PIL)."""
    import hashlib

    from yolov5m_tpu_torch.data import native

    def sha(img):
        return None if img is None else hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest()

    def attempt(fn, *args):
        try:
            return fn(*args)
        except ValueError:
            return None

    digests = {k: v for k, v in corpus.load().items()
               if prefixes is None or k.startswith(prefixes)}
    wrong, left = [], []
    made = corpus.made() if hasattr(corpus, "made") else {}
    with pil_blocked(), tempfile.TemporaryDirectory() as tmp:
        for name, data in made.items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        for name, want in sorted(digests.items()):
            path = os.path.join(tmp if name in made else corpus.FOLDER,
                                name)
            with open(path, "rb") as f:
                data = f.read()
            hw = attempt(native.read_image_size, path)
            got = {"loader": sha(native.decode_image(data)),
                   "load": sha(attempt(native.load_image_rgb, path)),
                   "img": sha(attempt(native.load_image_pillow, path)),
                   "hw": None if hw is None else list(hw)}
            why = left_to_pil(data)
            if why:
                left.append(name)
                # the port reads a TIFF's or a JPEG 2000's size, not that
                # of a file another plugin opens
                want = {"loader": None, "load": None, "img": None,
                        "hw": want["hw"] if why == "codec" else None}
            if got != want:
                wrong.append({"file": name, "got": got, "want": want})
    return digests, wrong, sum(v["img"] is None for v in digests.values()), \
        left


def tiff_route(card: str, npz: str) -> dict:
    """9l: TIFF as Pillow's TiffImagePlugin reads it over libtiff, in the
    port's own code (data/tiff.py, csrc/tiff_decode.cc): every file of
    the corpus and the seven 640x480 scenes against the digests of every
    JAX route and the size Pillow reads; one decode of each scene timed;
    the server and detect on the scenes against the same runs on PPM
    twins of their pixels, the kernel launched; detect's rate over LZW
    files against their PPM twins, in turns."""
    import hashlib

    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    corpus = tests_module("torch_tiff_corpus")
    digests, wrong, refused, left = tiff_corpus_routes(corpus)
    left = len(left)
    t0 = time.perf_counter()
    scenes = corpus.scene_cases(jpeg_fixtures().scene(0))
    made_s = time.perf_counter() - t0
    scene_digests = corpus.load(name=corpus.SCENE_DIGESTS)
    pixels = {n: native.decode_image(d) for n, d in scenes.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in scenes.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            hw = native.read_image_size(path)
            got = {r: hashlib.sha256(np.ascontiguousarray(img).tobytes())
                   .hexdigest() for r, img in (
                       ("loader", pixels[name]),
                       ("load", native.load_image_rgb(path)),
                       ("img", native.load_image_pillow(path)))}
            got["hw"] = list(hw)
            if got != scene_digests[name]:
                wrong.append({"file": name, "got": got,
                              "want": scene_digests[name]})
    log(f"9l TIFF corpus: {len(digests) - len(wrong)} of {len(digests)} "
        f"files and the {len(scenes)} scenes (made in {made_s:.1f} s) give "
        f"every JAX route's digests (Pillow's TiffImagePlugin over libtiff) "
        f"and Pillow's size ({refused} refused there; {left} left to PIL by "
        f"their tags, refused with PIL blocked, their size read)")
    if wrong:
        raise AssertionError(f"9l: the port differs from the JAX routes on "
                             f"{json.dumps(wrong)}")

    reps = P9L["decode_reps"]
    ms = {name: _median_ms(lambda d=data: native.decode_image(d), reps)
          for name, data in scenes.items()}
    log(f"9l one 640x480 decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")

    bs = P7["bs"]
    common = ["--nc", "80", "--weights", npz, "--fuse", "--device", "cuda"]
    names = sorted(scenes)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k)
                for k in ("tiff", "twins", "rate_tiff", "rate_ppm")}
        for d in dirs.values():
            os.makedirs(d)
        for i, name in enumerate(names):
            with open(os.path.join(dirs["tiff"], f"img{i}.jpg"), "wb") as f:
                f.write(scenes[name])
            with open(os.path.join(dirs["twins"], f"img{i}.ppm"), "wb") as f:
                f.write(native.encode_ppm(pixels[name]))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["tiff"], "--all", "--bs", str(bs), *common]))
        detect_launches = nms_kernel.keep_launches
        twin_results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["twins"], "--all", "--bs", str(bs),
             *common]))
        same_all = twin_results == {k.replace(".jpg", ".ppm"): v
                                    for k, v in results.items()}
        # --img: an LZW file of the scene under Orientation 6 (rotated on
        # decode, as Pillow's exif_transpose rotates it)
        rotated = corpus.encode(pixels[TIFF_RATE], "lzw", orientation=6)
        img = os.path.join(tmp, "scene_orient6.tif")
        with open(img, "wb") as f:
            f.write(rotated)
        twin = os.path.join(tmp, "scene_orient6.ppm")
        upright = native.load_image_pillow(img)
        with open(twin, "wb") as f:
            f.write(native.encode_ppm(upright))
        nms_kernel.keep_launches = 0
        _, out = _quiet(detect.main, detect.arg_parser(["--img", img,
                                                        *common]))
        img_launches = nms_kernel.keep_launches
        _, twin_out = _quiet(detect.main, detect.arg_parser(
            ["--img", twin, *common]))
        img_rows = _printed_detections(out)
        same_img = img_rows == _printed_detections(twin_out) and \
            upright.shape == (640, 480, 3) and np.array_equal(
                upright, np.ascontiguousarray(
                    pixels[TIFF_RATE].swapaxes(0, 1)[:, ::-1]))

        # detect's directory loop over LZW files and over their PPM twins,
        # under 7e's arguments, in turns
        n = P9L["rate_files"]
        for i in range(n):
            with open(os.path.join(dirs["rate_tiff"], f"img{i:02d}.jpg"),
                      "wb") as f:
                f.write(scenes[TIFF_RATE])
            with open(os.path.join(dirs["rate_ppm"], f"img{i:02d}.ppm"),
                      "wb") as f:
                f.write(native.encode_ppm(pixels[TIFF_RATE]))
        rates = {"tiff": [], "ppm": []}
        for _ in range(2):
            for kind in ("tiff", "ppm"):
                rates[kind].append(detect_dir_rate(detect.arg_parser(
                    ["--img_dir", dirs["rate_" + kind], "--all", "--bs",
                     str(bs), "--nc", "80", "--weights", npz, "--model",
                     P7["model"], "--first_out", str(P7["first_out"]),
                     "--image_size", str(P7["size"]), "--device", "cuda"]),
                    n))
    log(f"9l detect --all over {n} LZW TIFF files of the scene: "
        f"{json.dumps(rates['tiff'])} images/s against "
        f"{json.dumps(rates['ppm'])} over their PPM twins (each the median "
        f"of 3 passes, the two in turns, host decode and letterbox "
        f"included), on {card}")

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        frames = [scenes[n] for n in names]
        twin_frames = [native.encode_ppm(pixels[n]) for n in names]
        with DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in frames:                 # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in frames]
            serve_launches = nms_kernel.keep_launches
            for f in twin_frames:
                c.send(f)
            twin_replies = [c.recv() for _ in twin_frames]
    finally:
        server.stop()
    res = {"files": len(digests), "scenes": len(scenes), "refused": refused,
           "left_to_pil": left, "decode_ms": ms,
           "detect_launches": detect_launches,
           "detections": {n: len(results[f"img{i}.jpg"])
                          for i, n in enumerate(names)},
           "detect_equals_ppm": same_all, "img_launches": img_launches,
           "img_detections": len(img_rows), "img_equals_ppm": same_img,
           "serve_launches": serve_launches,
           "served_detections": {n: len(r.get("detections", []))
                                 for n, r in zip(names, replies)},
           "serve_equals_ppm": replies == twin_replies,
           "detect_images_per_s": {k: statistics.median(v)
                                   for k, v in rates.items()}}
    log(f"9l detect --all over the seven scenes, detect --img on an LZW "
        f"file under Orientation 6 and the server on the seven: "
        f"{json.dumps(res)}, on {card}")
    if not (same_all and same_img and res["serve_equals_ppm"]):
        raise AssertionError(f"9l: detections on the TIFF scenes differ "
                             f"from those on their PPM twins: "
                             f"{json.dumps(res)}")
    if not all(r.get("ok") for r in replies):
        raise AssertionError(f"9l: the server refused a frame: {replies}")
    if detect_launches != -(-len(names) // bs) or img_launches != 1 \
            or serve_launches < 1:
        raise AssertionError(f"9l: the kernel's launches: {json.dumps(res)}")
    if not all(res["detections"].values()) or not img_rows:
        raise AssertionError(f"9l: a scene without detections: "
                             f"{json.dumps(res)}")
    return res


# 9m: YCbCr and JPEG TIFF (tests/torch_tiff_jpeg_corpus.py); --img on the
# YCbCr JPEG scene under Orientation 6; the rate directories hold YCbCr
# 2x2 JPEG files of the scene and their PPM twins
TIFF_JPEG_RATE = "scene_ycbcr22_jpeg_640x480.tif"
P9M = {"rate_files": 24, "decode_reps": 5}


def tiff_jpeg_route(card: str, npz: str) -> dict:
    """9m: YCbCr and JPEG-compressed TIFF as Pillow reads them over
    libtiff's JPEG codec and TIFFRGBAImage, in the port's own code
    (data/tiff.py, csrc/jpeg_decode.cc mode 2, csrc/tiff_decode.cc): every
    file of the corpus with PIL blocked and the five 640x480 scenes made
    from the seed against the digests of every JAX route; one decode of
    each scene timed; detect and the server on the scenes against the
    same runs on PPM twins of their pixels, the kernel launched; detect's
    rate over YCbCr JPEG files against their PPM twins, in turns."""
    import hashlib

    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    corpus = tests_module("torch_tiff_jpeg_corpus")
    digests, wrong, refused, left = tiff_corpus_routes(corpus)
    left = len(left)
    t0 = time.perf_counter()
    scenes = corpus.scene_cases(jpeg_fixtures().scene(0))
    made_s = time.perf_counter() - t0
    scene_digests = corpus.load(name=corpus.SCENE_DIGESTS)
    pixels = {n: native.decode_image(d) for n, d in scenes.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in scenes.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            hw = native.read_image_size(path)
            got = {r: hashlib.sha256(np.ascontiguousarray(img).tobytes())
                   .hexdigest() for r, img in (
                       ("loader", pixels[name]),
                       ("load", native.load_image_rgb(path)),
                       ("img", native.load_image_pillow(path)))}
            got["hw"] = list(hw)
            if got != scene_digests[name]:
                wrong.append({"file": name, "got": got,
                              "want": scene_digests[name]})
    log(f"9m YCbCr/JPEG TIFF corpus: {len(digests) - len(wrong)} of "
        f"{len(digests)} files and the {len(scenes)} scenes (made in "
        f"{made_s:.1f} s) give every JAX route's digests (Pillow over "
        f"libtiff's JPEG codec and TIFFRGBAImage) and Pillow's size "
        f"({refused} refused there; {left} left to PIL)")
    if wrong or left:
        raise AssertionError(f"9m: the port differs from the JAX routes on "
                             f"{json.dumps(wrong)} ({left} left to PIL)")

    reps = P9M["decode_reps"]
    ms = {name: _median_ms(lambda d=data: native.decode_image(d), reps)
          for name, data in scenes.items()}
    log(f"9m one 640x480 decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")

    bs = P7["bs"]
    common = ["--nc", "80", "--weights", npz, "--fuse", "--device", "cuda"]
    names = sorted(scenes)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k)
                for k in ("tiff", "twins", "rate_tiff", "rate_ppm")}
        for d in dirs.values():
            os.makedirs(d)
        for i, name in enumerate(names):
            with open(os.path.join(dirs["tiff"], f"img{i}.jpg"), "wb") as f:
                f.write(scenes[name])
            with open(os.path.join(dirs["twins"], f"img{i}.ppm"), "wb") as f:
                f.write(native.encode_ppm(pixels[name]))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["tiff"], "--all", "--bs", str(bs), *common]))
        detect_launches = nms_kernel.keep_launches
        twin_results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["twins"], "--all", "--bs", str(bs),
             *common]))
        same_all = twin_results == {k.replace(".jpg", ".ppm"): v
                                    for k, v in results.items()}
        # --img: the YCbCr JPEG scene under Orientation 6 (rotated by
        # Pillow's exif_transpose after libjpeg's conversion)
        rotated = corpus.jpeg_tiff(jpeg_fixtures().scene(0), 6, (2, 2),
                                   tags={274: 6})
        img = os.path.join(tmp, "scene_orient6.tif")
        with open(img, "wb") as f:
            f.write(rotated)
        twin = os.path.join(tmp, "scene_orient6.ppm")
        upright = native.load_image_pillow(img)
        with open(twin, "wb") as f:
            f.write(native.encode_ppm(upright))
        nms_kernel.keep_launches = 0
        _, out = _quiet(detect.main, detect.arg_parser(["--img", img,
                                                        *common]))
        img_launches = nms_kernel.keep_launches
        _, twin_out = _quiet(detect.main, detect.arg_parser(
            ["--img", twin, *common]))
        img_rows = _printed_detections(out)
        same_img = img_rows == _printed_detections(twin_out) and \
            upright.shape == (640, 480, 3) and np.array_equal(
                upright, np.ascontiguousarray(
                    pixels[TIFF_JPEG_RATE].swapaxes(0, 1)[:, ::-1]))

        # detect's directory loop over YCbCr JPEG files and over their PPM
        # twins, under 7e's arguments, in turns
        n = P9M["rate_files"]
        for i in range(n):
            with open(os.path.join(dirs["rate_tiff"], f"img{i:02d}.jpg"),
                      "wb") as f:
                f.write(scenes[TIFF_JPEG_RATE])
            with open(os.path.join(dirs["rate_ppm"], f"img{i:02d}.ppm"),
                      "wb") as f:
                f.write(native.encode_ppm(pixels[TIFF_JPEG_RATE]))
        rates = {"tiff": [], "ppm": []}
        for _ in range(2):
            for kind in ("tiff", "ppm"):
                rates[kind].append(detect_dir_rate(detect.arg_parser(
                    ["--img_dir", dirs["rate_" + kind], "--all", "--bs",
                     str(bs), "--nc", "80", "--weights", npz, "--model",
                     P7["model"], "--first_out", str(P7["first_out"]),
                     "--image_size", str(P7["size"]), "--device", "cuda"]),
                    n))
    log(f"9m detect --all over {n} YCbCr 2x2 JPEG TIFF files of the scene: "
        f"{json.dumps(rates['tiff'])} images/s against "
        f"{json.dumps(rates['ppm'])} over their PPM twins (each the median "
        f"of 3 passes, the two in turns, host decode and letterbox "
        f"included), on {card}")

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        frames = [scenes[n] for n in names]
        twin_frames = [native.encode_ppm(pixels[n]) for n in names]
        with DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in frames:                 # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in frames]
            serve_launches = nms_kernel.keep_launches
            for f in twin_frames:
                c.send(f)
            twin_replies = [c.recv() for _ in twin_frames]
    finally:
        server.stop()
    res = {"files": len(digests), "scenes": len(scenes), "refused": refused,
           "decode_ms": ms, "detect_launches": detect_launches,
           "detections": {n: len(results[f"img{i}.jpg"])
                          for i, n in enumerate(names)},
           "detect_equals_ppm": same_all, "img_launches": img_launches,
           "img_detections": len(img_rows), "img_equals_ppm": same_img,
           "serve_launches": serve_launches,
           "served_detections": {n: len(r.get("detections", []))
                                 for n, r in zip(names, replies)},
           "serve_equals_ppm": replies == twin_replies,
           "detect_images_per_s": {k: statistics.median(v)
                                   for k, v in rates.items()}}
    log(f"9m detect --all over the five scenes, detect --img on the YCbCr "
        f"JPEG file under Orientation 6 and the server on the five: "
        f"{json.dumps(res)}, on {card}")
    if not (same_all and same_img and res["serve_equals_ppm"]):
        raise AssertionError(f"9m: detections on the TIFF scenes differ "
                             f"from those on their PPM twins: "
                             f"{json.dumps(res)}")
    if not all(r.get("ok") for r in replies):
        raise AssertionError(f"9m: the server refused a frame: {replies}")
    if detect_launches != -(-len(names) // bs) or img_launches != 1 \
            or serve_launches < 1:
        raise AssertionError(f"9m: the kernel's launches: {json.dumps(res)}")
    if not all(res["detections"].values()) or not img_rows:
        raise AssertionError(f"9m: a scene without detections: "
                             f"{json.dumps(res)}")
    return res


# 9n and 9o: TIFF whose 640x480 scenes are committed with the corpus (the
# card has no encoder the port may rely on). Each phase: its corpus module,
# what it holds, the decoders Pillow reads it over, the scene the rate
# directories copy (beside their PPM twins) and its kind; --img reads the
# corpus's ROTATED scene (Orientation 6)
P9N = {"rate_files": 24, "decode_reps": 5}
COMMITTED_SCENE_PHASES = {
    "9n": ("torch_tiff_zstd_lzma_corpus", "ZSTD/LZMA TIFF",
           "libtiff's ZSTDDecode and LZMADecode", "scene_zstd_640x480.tif",
           "ZSTD TIFF"),
    "9o": ("torch_tiff_ojpeg_corpus", "12-bit and old-style JPEG TIFF",
           "libtiff's jpeg12 branch and tif_ojpeg.c",
           "scene_oj_jif_22_640x480.tif", "old-style JPEG TIFF"),
    "9p.zstd": ("torch_tiff_zstd_legacy_corpus", "legacy zstd TIFF",
                "libzstd's v0.5-v0.7 streaming decoders under ZSTDDecode",
                "scene_z7_640x480.tif", "v0.7 ZSTD TIFF"),
    "9p.lab": ("torch_tiff_lab_corpus", "CIELab TIFF",
               "libtiff and LittleCMS's Lab to sRGB transform",
               "scene_lab_lzw_640x480.tif", "CIELab LZW TIFF"),
    # a corpus of several parts: the part's scenes, rotated scene and
    # files (corpus.PHASES)
    "9q.fax": ("torch_tiff_fax_corpus", "CCITT fax and SGILog TIFF",
               "libtiff's tif_fax3.c, and tif_luv.c's refusal",
               "scene_g4_640x480.tif", "Group 4 TIFF", "fax"),
    "9q.thunder": ("torch_tiff_fax_corpus", "ThunderScan TIFF",
                   "libtiff's tif_thunder.c", "scene_thunder_640x480.tif",
                   "ThunderScan TIFF", "thunder"),
    # JPEG 2000: no Orientation (corpus.ROTATED None: --img reads the rate
    # scene upright); the files whose markers name HTJ2K or Part 2's MCT
    # are left to PIL (corpus.LEFT_TO_PIL)
    "9r": ("torch_jpeg2k_corpus", "JPEG 2000",
           "OpenJPEG 2.5.4 under Jpeg2KDecode.c", "scene_ict_640x480.jp2",
           "JP2"),
    # the raster plugins: scenes made at run time (corpus.made()); the
    # files whose headers IMT or PCD opens are left to PIL
    "9s": ("torch_raster_corpus",
           "DIB, ICO, CUR, PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM",
           "its raster plugins in its open order",
           "scene_tga_rle_640x480.tga", "TGA RLE"),
    # DDS, BLP and FTEX: scenes made at run time (corpus.made()); no file
    # left to PIL
    "9t": ("torch_bcn_corpus", "DDS, BLP and FTEX",
           "its DDS, BLP and FTEX plugins and its bcn decoder",
           "scene_dds_bc7_640x480.dds", "DDS BC7"),
}


def committed_scenes_route(card: str, npz: str, phase: str) -> dict:
    """9n (ZSTD and LZMA TIFF: data/tiff.py, csrc/zstd_decode.cc,
    csrc/xz_decode.cc), 9o (12-bit JPEG and old-style JPEG TIFF:
    data/tiff.py, csrc/jpeg_decode.cc), a part of 9p or 9q
    (COMMITTED_SCENE_PHASES; a corpus of parts names each part's scenes
    and files in its PHASES), as Pillow reads them over libtiff, 9r
    (JPEG 2000 as Pillow reads it over OpenJPEG: data/jpeg2k.py,
    csrc/j2k_decode.cc), 9s (the raster plugins: data/raster.py,
    csrc/raster_decode.cc) or 9t (DDS, BLP and FTEX: data/bcn.py,
    csrc/bcn_decode.cc), in the port's own code: every file of the corpus
    with PIL blocked against the digests of every JAX route, none left to
    PIL but those the corpus names (LEFT_TO_PIL); one decode of each
    640x480 scene timed on one thread; detect and the server on the
    scenes against the same runs on PPM twins of their pixels, the kernel
    launched; detect --img on the rotated scene (or the rate scene where
    the corpus has none); detect's rate over copies of one scene against
    their PPM twins, in turns."""
    from yolov5m_tpu_torch.cli import detect, serve
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import DetectionClient

    module, what, over, rate_scene, rate_what, *part = \
        COMMITTED_SCENE_PHASES[phase]
    corpus = tests_module(module)
    scene_names, rotated, prefixes = corpus.PHASES[part[0]] if part else \
        (corpus.SCENES, corpus.ROTATED, None)
    digests, wrong, refused, left = tiff_corpus_routes(corpus, prefixes)
    allowed = getattr(corpus, "LEFT_TO_PIL", ())
    left_outside = [n for n in left if not n.startswith(allowed)]
    log(f"{phase} {what} corpus: {len(digests) - len(wrong)} of "
        f"{len(digests)} files, the {len(scene_names) + bool(rotated)} "
        f"scenes among them, give every JAX route's digests (Pillow over "
        f"{over}) and Pillow's size ({refused} refused there; "
        f"{len(left_outside)} left to PIL"
        + (f", and {len(left) - len(left_outside)} of the corpus's "
           f"LEFT_TO_PIL {list(allowed)}" if allowed else "") + ")")
    if wrong or left_outside:
        raise AssertionError(f"{phase}: the port differs from the JAX routes "
                             f"on {json.dumps(wrong)} ({left_outside} left "
                             f"to PIL)")

    made = corpus.made() if hasattr(corpus, "made") else {}

    def read(name):
        if name in made:
            return made[name]
        with open(os.path.join(corpus.FOLDER, name), "rb") as f:
            return f.read()
    scenes = {name: read(name) for name in scene_names}
    pixels = {n: native.decode_image(d) for n, d in scenes.items()}
    reps = P9N["decode_reps"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ms = {name: _median_ms(lambda d=data: native.decode_image(d), reps)
              for name, data in scenes.items()}
    finally:
        torch.set_num_threads(threads)
    log(f"{phase} one 640x480 decode, ms (median of {reps}, one thread): "
        f"{json.dumps(ms)} on {card}")

    bs = P7["bs"]
    common = ["--nc", "80", "--weights", npz, "--fuse", "--device", "cuda"]
    names = sorted(scenes)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k)
                for k in ("tiff", "twins", "rate_tiff", "rate_ppm")}
        for d in dirs.values():
            os.makedirs(d)
        for i, name in enumerate(names):
            with open(os.path.join(dirs["tiff"], f"img{i}.jpg"), "wb") as f:
                f.write(scenes[name])
            with open(os.path.join(dirs["twins"], f"img{i}.ppm"), "wb") as f:
                f.write(native.encode_ppm(pixels[name]))
        nms_kernel.keep_launches = 0
        results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["tiff"], "--all", "--bs", str(bs), *common]))
        detect_launches = nms_kernel.keep_launches
        twin_results, _ = _quiet(detect.main, detect.arg_parser(
            ["--img_dir", dirs["twins"], "--all", "--bs", str(bs),
             *common]))
        same_all = twin_results == {k.replace(".jpg", ".ppm"): v
                                    for k, v in results.items()}
        # --img: the rotated scene (Orientation 6: rotated by Pillow's
        # exif_transpose), or the rate scene where the corpus has none
        img = os.path.join(corpus.FOLDER, rotated or rate_scene)
        if (rotated or rate_scene) in made:
            img = os.path.join(tmp, rotated or rate_scene)
            with open(img, "wb") as f:
                f.write(made[rotated or rate_scene])
        twin = os.path.join(tmp, "scene_orient6.ppm")
        upright = native.load_image_pillow(img)
        with open(twin, "wb") as f:
            f.write(native.encode_ppm(upright))
        nms_kernel.keep_launches = 0
        _, out = _quiet(detect.main, detect.arg_parser(["--img", img,
                                                        *common]))
        img_launches = nms_kernel.keep_launches
        _, twin_out = _quiet(detect.main, detect.arg_parser(
            ["--img", twin, *common]))
        img_rows = _printed_detections(out)
        same_img = img_rows == _printed_detections(twin_out) and \
            np.array_equal(upright, pixels[rate_scene] if not rotated else
                           np.ascontiguousarray(
                               pixels[rate_scene].swapaxes(0, 1)[:, ::-1]))

        # detect's directory loop over copies of the rate scene and over
        # their PPM twins, under 7e's arguments, in turns
        n = P9N["rate_files"]
        for i in range(n):
            with open(os.path.join(dirs["rate_tiff"], f"img{i:02d}.jpg"),
                      "wb") as f:
                f.write(scenes[rate_scene])
            with open(os.path.join(dirs["rate_ppm"], f"img{i:02d}.ppm"),
                      "wb") as f:
                f.write(native.encode_ppm(pixels[rate_scene]))
        rates = {"tiff": [], "ppm": []}
        for _ in range(2):
            for kind in ("tiff", "ppm"):
                rates[kind].append(detect_dir_rate(detect.arg_parser(
                    ["--img_dir", dirs["rate_" + kind], "--all", "--bs",
                     str(bs), "--nc", "80", "--weights", npz, "--model",
                     P7["model"], "--first_out", str(P7["first_out"]),
                     "--image_size", str(P7["size"]), "--device", "cuda"]),
                    n))
    log(f"{phase} detect --all over {n} {rate_what} files of the scene: "
        f"{json.dumps(rates['tiff'])} images/s against "
        f"{json.dumps(rates['ppm'])} over their PPM twins (each the median "
        f"of 3 passes, the two in turns, host decode and letterbox "
        f"included), on {card}")

    server = serve.build_server(serve.arg_parser(
        ["--weights", npz, "--nc", "80", "--bs", str(bs), "--max_wait_ms",
         "1000", "--port", "0", "--device", "cuda"]))
    server.start()
    try:
        frames = [scenes[n] for n in names]
        twin_frames = [native.encode_ppm(pixels[n]) for n in names]
        with DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in frames:                 # pipelined: one batch
                c.send(f)
            replies = [c.recv() for _ in frames]
            serve_launches = nms_kernel.keep_launches
            for f in twin_frames:
                c.send(f)
            twin_replies = [c.recv() for _ in twin_frames]
    finally:
        server.stop()
    res = {"files": len(digests), "scenes": len(scenes), "refused": refused,
           "left_to_pil": len(left), "decode_ms": ms,
           "detect_launches": detect_launches,
           "detections": {n: len(results[f"img{i}.jpg"])
                          for i, n in enumerate(names)},
           "detect_equals_ppm": same_all, "img_launches": img_launches,
           "img_detections": len(img_rows), "img_equals_ppm": same_img,
           "serve_launches": serve_launches,
           "served_detections": {n: len(r.get("detections", []))
                                 for n, r in zip(names, replies)},
           "serve_equals_ppm": replies == twin_replies,
           "detect_images_per_s": {k: statistics.median(v)
                                   for k, v in rates.items()}}
    log(f"{phase} detect --all over the {len(names)} scenes named .jpg, "
        f"detect --img on the {rate_what} file"
        f"{' under Orientation 6' if rotated else ''} and the server on the "
        f"{len(names)}: {json.dumps(res)}, on {card}")
    if not (same_all and same_img and res["serve_equals_ppm"]):
        raise AssertionError(f"{phase}: detections on the {what} scenes "
                             f"differ from those on their PPM twins: "
                             f"{json.dumps(res)}")
    if not all(r.get("ok") for r in replies):
        raise AssertionError(f"{phase}: the server refused a frame: {replies}")
    if detect_launches != -(-len(names) // bs) or img_launches != 1 \
            or serve_launches < 1:
        raise AssertionError(f"{phase}: the kernel's launches: "
                             f"{json.dumps(res)}")
    if not all(res["detections"].values()) or not img_rows:
        raise AssertionError(f"{phase}: a scene without detections: "
                             f"{json.dumps(res)}")
    return res


def pillow_decode_times(card: str, phase: str,
                        codec: str | None = None) -> dict | None:
    """The decode the JAX routes make (Pillow's Image.open and
    convert("RGB")) beside the port's, on one thread, over the scenes of a
    committed-scenes phase, in turns: a comparison of the two on this host
    only (the port never calls Pillow), with whether each pair of pixels
    is equal (the corpus phase holds the port to the digests; this host's
    Pillow may be another version). None where PIL is not importable."""
    import io

    from yolov5m_tpu_torch.data import native

    try:
        from PIL import Image, features
    except ImportError:
        log(f"{phase} Pillow's decode: not measured (no PIL here)")
        return None
    module, *_ = COMMITTED_SCENE_PHASES[phase]
    corpus = tests_module(module)
    made = corpus.made() if hasattr(corpus, "made") else {}
    scenes = {}
    for name in corpus.SCENES:
        if name in made:
            scenes[name] = made[name]
            continue
        with open(os.path.join(corpus.FOLDER, name), "rb") as f:
            scenes[name] = f.read()

    def pillow(data):
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    same = {n: bool(np.array_equal(pillow(d), native.decode_image(d)))
            for n, d in scenes.items()}
    reps = P9N["decode_reps"]
    times = {n: {"port": [], "pillow": []} for n in scenes}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(reps):
            for n, d in scenes.items():
                for arm, fn in (("port", native.decode_image),
                                ("pillow", pillow)):
                    t0 = time.perf_counter()
                    fn(d)
                    times[n][arm].append(1e3 * (time.perf_counter() - t0))
    finally:
        torch.set_num_threads(threads)
    res = {"pillow": Image.__version__,
           "codec": codec and features.version_codec(codec), "equal": same,
           "ratio": {n: statistics.median(t["port"]) /
                     statistics.median(t["pillow"])
                     for n, t in times.items()},
           "ms": {n: {arm: statistics.median(v) for arm, v in t.items()}
                  for n, t in times.items()}}
    over = f" over {codec} {res['codec']}" if codec else ""
    log(f"{phase} one decode of each scene, ms (median of {reps}, one "
        f"thread, the port and Pillow {res['pillow']}{over} in turns): "
        f"{json.dumps(res)} on {card}")
    return res


def legacy_lab_route(card: str, npz: str) -> dict:
    """9p: legacy zstd frames in ZSTD TIFF and CIELab TIFF, as Pillow
    reads them over libtiff, libzstd's legacy decoders and LittleCMS, in
    the port's own code, PIL blocked throughout: the Lab to RGB transform
    of all 2^24 LAB pixels against the committed digest of Pillow's, then
    each corpus as 9n and 9o run theirs (committed_scenes_route)."""
    import hashlib

    from yolov5m_tpu_torch.data import native

    with pil_blocked():
        lab = tests_module("torch_tiff_lab_corpus")
        with open(os.path.join(lab.FOLDER, lab.TRANSFORM)) as f:
            want = json.load(f)["sha256"]
        px = lab.all_storage()
        native.lab_to_srgb(px[:1, :1])                # the table, built
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            t0 = time.perf_counter()
            rgb = native.lab_to_srgb(px)
            transform_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.set_num_threads(threads)
        got = hashlib.sha256(rgb.tobytes()).hexdigest()
        log(f"9p Lab to RGB of all 2^24 LAB pixels: sha256 {got} "
            f"({'equal to' if got == want else 'NOT'} Pillow's committed "
            f"{want}), {transform_ms:.1f} ms on one thread, on {card}")
        if got != want:
            raise AssertionError("9p: the port's Lab to RGB differs from "
                                 "Pillow's LittleCMS transform")
        zstd = committed_scenes_route(card, npz, "9p.zstd")
        cielab = committed_scenes_route(card, npz, "9p.lab")
    return {"transform_sha256": got, "transform_ms": transform_ms,
            "zstd": zstd, "lab": cielab}


def fax_thunder_route(card: str, npz: str) -> dict:
    """9q: CCITT fax TIFF (RLE, RLEW, Group 3, Group 4), ThunderScan TIFF
    and SGILog TIFF, as Pillow reads or refuses them over libtiff, in the
    port's own code, PIL blocked for the phase: committed_scenes_route
    for "9q.fax" and "9q.thunder", each over its part of the corpus."""
    with pil_blocked():
        fax = committed_scenes_route(card, npz, "9q.fax")
        thunder = committed_scenes_route(card, npz, "9q.thunder")
    return {"fax": fax, "thunder": thunder}


def host_export_phase(card: str, root: str, npz: str, p4: dict,
                      flagship: dict, stripped: dict,
                      ppm_images_per_s: float) -> dict:
    """Phase 9. p4: phase 4's model and frames (on the card) and its
    valid counts; ppm_images_per_s: 7e's detect rate."""
    t0 = time.perf_counter()
    host = native_host(card, root)
    jpeg = jpeg_paths(card, npz, ppm_images_per_s)
    gate = compact_gate(card, p4)
    exp = export_phase(card, flagship, stripped, p4["frames"])
    trace = traced_batch(card, p4)
    ops = host_ops(card)
    plots = plot_fixtures(card)
    pillow = pillow_route(card, npz)
    t9j = time.perf_counter()
    webp = webp_route(card, npz)
    log(f"9j: {time.perf_counter() - t9j:.1f} s")
    t9k = time.perf_counter()
    pnm = pnm_route(card, npz)
    log(f"9k: {time.perf_counter() - t9k:.1f} s")
    t9l = time.perf_counter()
    tif = tiff_route(card, npz)
    log(f"9l: {time.perf_counter() - t9l:.1f} s")
    t9m = time.perf_counter()
    tif_jpeg = tiff_jpeg_route(card, npz)
    log(f"9m: {time.perf_counter() - t9m:.1f} s")
    t9n = time.perf_counter()
    tif_zstd = committed_scenes_route(card, npz, "9n")
    log(f"9n: {time.perf_counter() - t9n:.1f} s")
    t9o = time.perf_counter()
    tif_ojpeg = committed_scenes_route(card, npz, "9o")
    log(f"9o: {time.perf_counter() - t9o:.1f} s")
    t9p = time.perf_counter()
    tif_legacy_lab = legacy_lab_route(card, npz)
    log(f"9p: {time.perf_counter() - t9p:.1f} s")
    t9q = time.perf_counter()
    tif_fax = fax_thunder_route(card, npz)
    log(f"9q: {time.perf_counter() - t9q:.1f} s")
    t9r = time.perf_counter()
    with pil_blocked():
        j2k = committed_scenes_route(card, npz, "9r")
    j2k["pillow_decode"] = pillow_decode_times(card, "9r", "jpg_2000")
    log(f"9r: {time.perf_counter() - t9r:.1f} s")
    t9s = time.perf_counter()
    with pil_blocked():
        raster = committed_scenes_route(card, npz, "9s")
    raster["pillow_decode"] = pillow_decode_times(card, "9s")
    log(f"9s: {time.perf_counter() - t9s:.1f} s")
    t9t = time.perf_counter()
    with pil_blocked():
        bcn = committed_scenes_route(card, npz, "9t")
    bcn["pillow_decode"] = pillow_decode_times(card, "9t")
    log(f"9t: {time.perf_counter() - t9t:.1f} s")
    log(f"phase 9 (host preprocessing, JPEG, compact gate, export, trace, "
        f"host ops and PNG, prediction images, the Pillow routes, WebP, "
        f"PNM, TIFF, YCbCr and JPEG TIFF, ZSTD and LZMA TIFF, 12-bit and "
        f"old-style JPEG TIFF, legacy zstd and CIELab TIFF, fax, "
        f"ThunderScan and SGILog TIFF, JPEG 2000, the raster formats, "
        f"DDS, BLP and FTEX): "
        f"{time.perf_counter() - t0:.1f} s")
    return {"native": host, "jpeg": jpeg, "gate": gate, "export": exp,
            "trace": trace, "host_ops": ops, "plots": plots,
            "pillow": pillow, "webp": webp, "pnm": pnm, "tiff": tif,
            "tiff_jpeg": tif_jpeg, "tiff_zstd_lzma": tif_zstd,
            "tiff_ojpeg": tif_ojpeg, "tiff_legacy_lab": tif_legacy_lab,
            "tiff_fax": tif_fax, "jpeg2k": j2k, "raster": raster,
            "bcn": bcn}


# -- phase 10: int8 PTQ and the s2d stem, full width --------------------------

# calibration frames (the first of phase 4's first batch), f32 frames of
# 10a, timed rounds after warmup rounds (each arm once a round, in turn),
# detections compared per image (bf16's top ones), and the bounds: s2d
# against 6x6 in bf16 (relative RMS of each scale's logits: one bf16
# rounding of the stem's output, 0.4% an element, carried through the
# net) and in f32 with TF32 off (share of the largest logit: sums in
# another order); the f32 int8 chain on the card against the CPU (SiLU
# ulps flip codes at rounding ties: the bound of the port against JAX at
# full width, tests/test_torch_quantize.py::test_int8_flagship_matches_jax);
# int8 against bf16: twice the flagship's own int8 deviation in JAX at 640
# (0.0477, that test; JAX's 2% budget, tests/test_quantize.py:41-57, was
# set on a first_out 8 model with random weights and holds for neither
# package on the flagship), and JAX's median IoU bound
# (tests/test_quantize_learned.py:94-96)
P10 = {"calib": 8, "f32_frames": 8, "rounds": 9, "warmup": 2, "top": 5,
       "s2d_bf16_rms": 0.02, "s2d_f32_tol": 1e-4, "card_vs_cpu_rms": 1e-2,
       "int8_rms": 0.1, "min_median_iou": 0.85}


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def median_top_iou(ref_rows: list, rows: list) -> tuple:
    """(median, count) over images of the IoU of each of the reference's
    top P10["top"] detections with its best match among rows; rows:
    (n, 6) tensors [class, conf, x1, y1, x2, y2] sorted by conf."""
    from yolov5m_tpu_torch.ops.boxes import pairwise_iou_xyxy

    ious = []
    for ref, got in zip(ref_rows, rows):
        top = ref[:P10["top"]]
        if len(top) and len(got):
            ious += pairwise_iou_xyxy(top[:, 2:6], got[:, 2:6]).max(
                1).values.tolist()
    return (statistics.median(ious) if ious else 0.0), len(ious)


def _detections(det, valid) -> list:
    return [d[v].float().cpu() for d, v in zip(det, valid)]


@contextlib.contextmanager
def _no_tf32():
    """f32 convolutions and matmuls in full f32 inside (TF32 off)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _main_kw() -> dict:
    from yolov5m_tpu_torch.config import Config
    cfg = Config()
    return dict(conf_threshold=0.25, iou_threshold=cfg.nms_iou_thresh,
                max_detections=cfg.max_detections,
                pre_nms_topk=cfg.topk_for_conf(0.25))


def interleaved_rounds(arms: dict, frames: list, counted: str) -> tuple:
    """Images/s of each arm (name -> model) through normalize -> model ->
    fused_detect, each round one batch per arm in turn: medians of
    P10["rounds"] after P10["warmup"]; the NMS launches of the arm
    ``counted``; each arm's peak GiB over one more round."""
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    kw = _main_kw()
    anchors = torch.from_numpy(normalized_anchors()).cuda()

    def run(model, x_u8):
        preds = model(normalize_uint8(x_u8, torch.bfloat16))
        fused_detect(preds, anchors, **kw)[1].sum().item()

    times = {name: [] for name in arms}
    launches = 0
    for r in range(P10["warmup"] + P10["rounds"]):
        for name, model in arms.items():
            before = nms_kernel.keep_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(model, frames[r % len(frames)])
            if r >= P10["warmup"]:
                times[name].append(time.perf_counter() - t0)
            if name == counted:
                launches += nms_kernel.keep_launches - before
    bs = frames[0].shape[0]
    ips = {n: bs / statistics.median(t) for n, t in times.items()}
    peak = {}
    for name, model in arms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(model, frames[0])
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    return ips, peak, launches


def s2d_stem(card: str, p4: dict) -> dict:
    """10a: the flagship with the s2d stem against phase 4's 6x6 model."""
    from yolov5m_tpu_torch.models.s2d import space_to_depth2, stem_weights_to_s2d
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    sd, _ = load_flagship(fold=True, device="cuda")
    s2d_sd = stem_weights_to_s2d(sd)

    def build(stem_s2d, weights, dtype):
        m = YOLOv5(fused=True, stem_s2d=stem_s2d)
        m.load_state_dict(weights, strict=True)
        return m.to(device="cuda", dtype=dtype,
                    memory_format=torch.channels_last).eval()

    model, s2d_model = p4["model"], build(True, s2d_sd, torch.bfloat16)
    frames = p4["frames"]
    with torch.inference_mode():
        x = normalize_uint8(frames[0], torch.bfloat16)
        x6, xs = x.permute(0, 3, 1, 2), space_to_depth2(x).permute(0, 3, 1, 2)
        stem = {"6x6": cuda_ms(lambda: model.backbone[0](x6), 20),
                "s2d": cuda_ms(lambda: s2d_model.backbone[0](xs), 20),
                "space_to_depth": cuda_ms(lambda: space_to_depth2(x), 20)}
        bf16_rms = [rel_rms(a, b) for a, b in zip(s2d_model(x), model(x))]
        with _no_tf32():
            m6, ms = build(False, sd, torch.float32), build(True, s2d_sd,
                                                            torch.float32)
            x8 = normalize_uint8(frames[0][:P10["f32_frames"]], torch.float32)
            f32_err = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(ms(x8), m6(x8)))
            del m6, ms
        ips, peak, launches = interleaved_rounds(
            {"6x6": model, "s2d": s2d_model}, frames, "s2d")
    res = {"stem_ms": stem, "bf16_rel_rms": bf16_rms, "f32_err": f32_err,
           "images_per_s": ips, "peak_gib": peak, "s2d_launches": launches}
    log(f"10a s2d stem: {json.dumps(res)} on {card}")
    want = P10["rounds"] + P10["warmup"]
    if launches != want:
        raise AssertionError(f"10a: the s2d main path launched the NMS kernel "
                             f"{launches} times in {want} batches")
    if max(bf16_rms) > P10["s2d_bf16_rms"] or f32_err > P10["s2d_f32_tol"]:
        raise AssertionError(f"10a: s2d against the 6x6 stem: bf16 relative "
                             f"RMS {bf16_rms}, f32 {f32_err}")
    return res


def int_mm_layouts() -> dict:
    """Which operand layouts torch._int_mm takes on the card (M 4096, K 112,
    N 48): A row-major or the transpose of a row-major (K, M), B the
    transpose of a row-major (N, K) or row-major (K, N). conv_int8 passes
    the first of each."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    a = torch.randint(-127, 128, (4096, 112), dtype=torch.int8,
                      device="cuda", generator=gen)
    w = torch.randint(-127, 128, (48, 112), dtype=torch.int8, device="cuda",
                      generator=gen)
    want = (a.double() @ w.double().t()).to(torch.int32)
    out = {}
    for an, aa in (("A row-major", a), ("A transposed", a.t().contiguous().t())):
        for bn, bb in (("B transposed", w.t()),
                       ("B row-major", w.t().contiguous())):
            try:
                ok = torch.equal(torch._int_mm(aa, bb), want)
                out[f"{an}, {bn}"] = "equal" if ok else "UNEQUAL"
            except RuntimeError as e:
                out[f"{an}, {bn}"] = "refused: " + str(e).splitlines()[0][:80]
    if out["A row-major, B transposed"] != "equal":
        raise AssertionError(f"10b: _int_mm on conv_int8's layout: {out}")
    return out


def int8_accumulators(card: str, models: dict, x: torch.Tensor) -> dict:
    """10b: every distinct conv_int8 call (codes, weights, stride, pad) of
    the int8 models on the frames x, on the card through torch._int_mm,
    against the plain float64 conv on the CPU on the same int8 inputs:
    the int32 accumulators must be equal."""
    from yolov5m_tpu_torch.models import blocks

    calls = {}
    real = blocks.conv_int8

    def record(q, w_q, stride=1, pad=0):
        key = (tuple(q.shape), tuple(w_q.shape), stride, pad)
        if key not in calls:
            calls[key] = (q.cpu(), w_q.cpu())
        return real(q, w_q, stride, pad)

    blocks.conv_int8 = record
    try:
        with torch.inference_mode():
            for model in models.values():
                model(x)
    finally:
        blocks.conv_int8 = real
    unequal = []
    t0 = time.perf_counter()
    for (qs, ws, stride, pad), (q, w_q) in calls.items():
        got = real(q.cuda(), w_q.cuda(), stride, pad).cpu()
        if not torch.equal(got, blocks.conv_int8_plain(q, w_q, stride, pad)):
            unequal.append([qs, ws, stride, pad])
    shapes = [[list(k[0]), list(k[1]), k[2], k[3]] for k in calls]
    res = {"shapes": len(calls), "unequal": len(unequal),
           "layouts": int_mm_layouts(), "plain_s": time.perf_counter() - t0}
    log(f"10b int8 accumulators: {len(calls)} distinct conv_int8 calls "
        f"(codes NHWC, weights OIHW, stride, pad): {json.dumps(shapes)}")
    log(f"10b: {json.dumps(res)} on {card}")
    if unequal:
        raise AssertionError(f"10b: int32 accumulators differ from the "
                             f"float64 conv at {unequal}")
    return res


def int8_stage_split(model, x: torch.Tensor) -> dict:
    """Device ms of one int8 forward on x, and of its conv_int8 calls
    (patch gather and weight layout, then torch._int_mm) and its
    torch._int_mm calls within them: CUDA events around each call, summed
    after one sync. The rest of the forward is the float side: quantize,
    the f32 epilogues (scale, bias, SiLU, requantize), pools, upsamples,
    the head."""
    from yolov5m_tpu_torch.models import blocks

    spans = {"conv_int8": [], "int_mm": []}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    real_conv, real_mm = blocks.conv_int8, torch._int_mm
    blocks.conv_int8 = timed("conv_int8", real_conv)
    torch._int_mm = timed("int_mm", real_mm)
    try:
        with torch.inference_mode():
            forward = cuda_ms(lambda: model(x), 1)
    finally:
        blocks.conv_int8, torch._int_mm = real_conv, real_mm
    torch.cuda.synchronize()
    ms = {n: sum(a.elapsed_time(b) for a, b in v) for n, v in spans.items()}
    return {"forward_ms": forward, "conv_int8_ms": ms["conv_int8"],
            "int_mm_ms": ms["int_mm"],
            "gather_ms": ms["conv_int8"] - ms["int_mm"],
            "rest_ms": forward - ms["conv_int8"],
            "int_mm_calls": len(spans["int_mm"])}


def int8_card_vs_cpu(qsd: dict, x: torch.Tensor) -> list:
    """The int8 chain with f32 activations (TF32 off) on the frames x, on
    the card and on the CPU: relative RMS of each scale's logits."""
    from yolov5m_tpu_torch.models.yolo import YOLOv5

    outs = []
    for device in ("cuda", "cpu"):
        model = YOLOv5(fused=True, quant="chain",
                       compute_dtype=torch.float32)
        model.load_state_dict(qsd, strict=True)
        with _no_tf32(), torch.inference_mode():
            outs.append([p.cpu() for p in model.to(device).eval()(
                x.to(device))])
    return [rel_rms(a, b) for a, b in zip(*outs)]


def int8_main_path(card: str, p4: dict) -> dict:
    """10b and 10c: the flagship quantized (chain and per block) on phase
    4's first P10["calib"] frames; its accumulators (10b); 128 frames
    through normalize -> int8 model -> fused_detect (K 512) against the
    fused bf16 model of phase 4."""
    from yolov5m_tpu_torch.models.quantize import quantize_int8
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    sd, _ = load_flagship(fold=True, device="cuda")
    template = YOLOv5(fused=True, compute_dtype=torch.bfloat16)
    frames = p4["frames"]
    calib = [normalize_uint8(frames[0][:P10["calib"]], torch.float32)]
    t0 = time.perf_counter()
    int8, qsd = {}, {}
    for name in ("chain", "block"):
        int8[name], qsd[name] = quantize_int8(template, sd, calib,
                                              chain=name == "chain")
    quant_s = time.perf_counter() - t0
    del sd
    one = normalize_uint8(frames[0][:1], torch.float32)
    acc = int8_accumulators(card, int8, one.to(torch.bfloat16))
    card_vs_cpu = int8_card_vs_cpu(qsd["chain"], one)

    kw = _main_kw()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    res = {"quantize_s": quant_s, "accumulators": acc,
           "f32_card_vs_cpu_rel_rms": card_vs_cpu}
    with torch.inference_mode():
        x = normalize_uint8(frames[0], torch.bfloat16)
        ref = p4["model"](x)
        ref_rows = _detections(*fused_detect(ref, anchors, **kw))
        for name, model in int8.items():
            nms_kernel.keep_launches = 0
            preds = model(x)
            det, valid = fused_detect(preds, anchors, **kw)
            launches = nms_kernel.keep_launches
            det_p, valid_p = fused_detect(preds, anchors, backend="torch", **kw)
            iou, n = median_top_iou(ref_rows, _detections(det, valid))
            res[name] = {"launches": launches,
                         "plain_nms_equal": bool(torch.equal(det, det_p) and
                                                 torch.equal(valid, valid_p)),
                         "logit_rel_rms": [rel_rms(a, b)
                                           for a, b in zip(preds, ref)],
                         "median_top_iou": iou, "ious": n,
                         "detections_per_image":
                             float(valid.sum(1).float().mean())}
        ips, peak, launches = interleaved_rounds(
            {"bf16": p4["model"], **int8}, frames, "chain")
        split = {name: int8_stage_split(model, x)
                 for name, model in int8.items()}
        split["bf16_forward_ms"] = cuda_ms(lambda: p4["model"](x), 5)
    trace = traced_batch(card, {"model": int8["chain"], "frames": frames},
                         "10c trace of one int8 chain batch")
    res.update(images_per_s=ips, peak_gib=peak, int8_launches=launches,
               stage_split=split, trace=trace)
    log(f"10c int8 main path: {json.dumps(res)} on {card}")
    for name in int8:
        r = res[name]
        if r["launches"] != 1 or not r["plain_nms_equal"]:
            raise AssertionError(f"10c {name}: {r['launches']} NMS launches "
                                 f"for one batch, plain NMS equal "
                                 f"{r['plain_nms_equal']}")
        if (max(r["logit_rel_rms"]) > P10["int8_rms"]
                or r["median_top_iou"] <= P10["min_median_iou"]):
            raise AssertionError(f"10c {name}: int8 against bf16: logits "
                                 f"{r['logit_rel_rms']}, median IoU "
                                 f"{r['median_top_iou']}")
    if max(card_vs_cpu) > P10["card_vs_cpu_rms"]:
        raise AssertionError(f"10c: the f32 int8 chain on the card against "
                             f"the CPU: {card_vs_cpu}")
    want = P10["rounds"] + P10["warmup"]
    if launches != want:
        raise AssertionError(f"10c: the int8 chain launched the NMS kernel "
                             f"{launches} times in {want} batches")
    return res


def int8_detect_cli(card: str, root: str, npz: str, bf16_results: dict) -> dict:
    """10d: cli.detect.main --all --int8 over phase 7's val PPM directory
    at bs 16: one launch a batch, the calibration line, a result for every
    image, the same results with the plain NMS, and detections that match
    7e's bf16 ones (median IoU of bf16's top ones)."""
    from yolov5m_tpu_torch.cli import detect
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    img_dir = os.path.join(root, "images", "val")
    args = ["--img_dir", img_dir, "--all", "--int8", "--bs", str(P7["bs"]),
            "--nc", "80", "--weights", npz, "--model", P7["model"],
            "--first_out", str(P7["first_out"]), "--image_size",
            str(P7["size"]), "--device", "cuda"]
    n = len(detect.list_images(img_dir))
    nms_kernel.keep_launches = 0
    t0 = time.perf_counter()
    results, out = _quiet(detect.main, detect.arg_parser(args))
    seconds = time.perf_counter() - t0
    launches = nms_kernel.keep_launches
    plain, _ = _quiet(detect.main, detect.arg_parser(args),
                      nms_backend="torch")

    def rows(res):
        return [torch.tensor([[0.0, d["conf"], *d["box_xyxy"]] for d in
                              res[name]]).reshape(-1, 6) for name in sorted(res)]

    iou, count = median_top_iou(rows(bf16_results), rows(results))
    line = [ln for ln in out.splitlines() if "int8 PTQ" in ln]
    per_image = sum(len(v) for v in results.values()) / max(n, 1)
    res = {"launches": launches, "calibration_line": line,
           "images": len(results), "detections_per_image": per_image,
           "median_top_iou_vs_bf16": iou, "ious": count,
           "seconds_with_calibration": seconds}
    log(f"10d detect --all --int8: {json.dumps(res)} on {card}")
    want = -(-n // P7["bs"])
    if launches != want:
        raise AssertionError(f"10d: {launches} NMS launches for {n} images at "
                             f"bs {P7['bs']}")
    if line != [f"==> int8 PTQ (calibrated on {min(n, 8)} images)"]:
        raise AssertionError(f"10d: the calibration line: {line}")
    if sorted(results) != sorted(bf16_results) or plain != results:
        raise AssertionError("10d: results missing, or differing from the "
                             "plain NMS's")
    if iou <= P10["min_median_iou"]:
        raise AssertionError(f"10d: median IoU {iou} against 7e's bf16")
    return res


def int8_phase(card: str, p4: dict, root: str, npz: str,
               bf16_results: dict) -> dict:
    """Phase 10: s2d (10a), int8 accumulators (10b), the int8 main path
    (10c) and detect --int8 (10d)."""
    t0 = time.perf_counter()
    s2d = s2d_stem(card, p4)
    torch.cuda.empty_cache()
    main = int8_main_path(card, p4)
    torch.cuda.empty_cache()
    det = int8_detect_cli(card, root, npz, bf16_results)
    log(f"phase 10 (int8 PTQ and the s2d stem): "
        f"{time.perf_counter() - t0:.1f} s")
    return {"s2d": s2d, "int8": main, "detect": det}


# -- phase 11: spatial, tensor and pipeline parallelism on one card -------

# grids name cuda:0 in every cell (one card). Parity runs in f32 with
# TF32 off, rates in bf16 with channels_last. 11a/11c: SP and TP
# detections against the one-device pipeline (valid equal, the rest
# within DET_TOL absolute plus DET_TOL of the value); 11b/11c train steps
# against the plain Trainer on the global batch: the loss within
# LOSS_RTOL of the flagship's loss (about 0.37 at bs 4, so tighter than
# the CPU tests' 2e-5 absolute), grad_norm within GNORM_RTOL, parameters
# and EMA within PARAM_ATOL (+-2 lr), BN buffers within BUFFER_TOL
# (relative above 1). 11d: PP against one device per micro-batch and
# against the Trainer at accumulate M on the same micro-batches within
# PP_TOL (JAX's bound, tests/test_pp.py), with deterministic cuDNN
P11 = {"bs": 16, "train_bs": 4, "rounds": 5, "ms_rounds": 10, "micro": 4,
       "mb": 4, "train_rounds": 3}
DET_TOL, PP_TOL = 1e-4, 1e-5
LOSS_RTOL, GNORM_RTOL, PARAM_ATOL, BUFFER_TOL = 1e-5, 1e-3, 2.1e-3, 1e-4
# 11e, f32: a reply's confidence (rounded to 1e-5) and box (0.01 px)
SERVE_CONF_TOL, SERVE_BOX_TOL = 2e-5, 0.02


def _cells(n_rows: int, n_cols: int) -> list:
    return [["cuda:0"] * n_cols for _ in range(n_rows)]


@contextlib.contextmanager
def _deterministic():
    """Deterministic cuDNN and torch ops (warnings only where a op has no
    deterministic version), as in 8b."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = flag


def _det_error(got, want, tol: float) -> tuple:
    """(valid masks equal, max |error|, all within tol + tol * |want|)."""
    det, valid = got
    wdet, wvalid = want
    if not torch.equal(valid, wvalid):
        return False, None, False
    err = (det[valid] - wdet[wvalid]).abs()
    ok = bool((err <= tol + tol * wdet[wvalid].abs()).all())
    return True, float(err.max()) if err.numel() else 0.0, ok


def _grid_check(infer, plain, x, want) -> dict:
    """One batch through a grid's infer function, the NMS launches counted
    from 0 around it, against the one-device detections ``want`` (valid
    equal, within DET_TOL, bitwise or not) and against the same grid with
    the plain NMS."""
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    nms_kernel.keep_launches = 0
    got = infer(x)
    torch.cuda.synchronize()
    n = nms_kernel.keep_launches
    same_valid, err, ok = _det_error(got, want, DET_TOL)
    ref = plain(x)
    return {"bs": x.shape[0], "launches": n, "valid_equal": same_valid,
            "max_abs_err": err, "within_tol": ok,
            "bitwise": bool(same_valid and torch.equal(got[0], want[0])),
            "plain_nms_equal": bool(torch.equal(got[0], ref[0])
                                    and torch.equal(got[1], ref[1])),
            "detections": int(got[1].sum())}


def _bad_checks(checks: list) -> list:
    return [c for c in checks if not (c["valid_equal"] and c["within_tol"]
                                      and c["plain_nms_equal"]
                                      and c["launches"] == 1)]


def _timed(fn, rounds: int, warmup: int = 2) -> float:
    """Median host seconds of fn() to a device sync, after warmup calls."""
    times = []
    for r in range(warmup + rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if r >= warmup:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _device_ms(fn, rounds: int = 3) -> dict:
    """One fn() queued behind a spinning kernel of some 120 ms: medians of
    the device ms from the call's start to its end (CUDA events), of the
    host ms to issue it, and of the spin. Where the host issues in less
    than the spin, the device ms is the call's device work alone, without
    the host's pace."""
    dev, host, spin = [], [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        marks[1].record()
        fn()
        marks[2].record()
        host.append(1e3 * (time.perf_counter() - t0))
        marks[2].synchronize()
        spin.append(marks[0].elapsed_time(marks[1]))
        dev.append(marks[1].elapsed_time(marks[2]))
    return {"device_ms": statistics.median(dev),
            "host_issue_ms": statistics.median(host),
            "spin_ms": statistics.median(spin)}


def _peak(fn) -> tuple:
    """(fn(), peak GiB allocated while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 30


def _p11_fused(flagship: dict, dtype) -> torch.nn.Module:
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.models.fuse import fold_batchnorm
    from yolov5m_tpu_torch.models.yolo import YOLOv5

    cfg = Config()
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, fused=True)
    model.load_state_dict(fold_batchnorm(flagship), strict=True)
    return model.to(device="cuda", dtype=dtype,
                    memory_format=torch.channels_last).eval()


def grid_inference(card: str, kind: str, flagship: dict, frames) -> dict:
    """11a (kind "sp") and the inference of 11c ("tp"): the flagship over
    1x2, 1x4 (SP) and 2x2 grids of cuda:0 at bs 1 (SP) and 16, f32 with
    TF32 off, against the one-device pipeline; one launch a batch; the
    same detections with the plain NMS. Then in bf16 the bs-1 ms a batch
    (SP) and the bs-16 images/s of each grid and of one device, and each
    path's peak GiB."""
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
    from yolov5m_tpu_torch import parallel

    kw = _main_kw()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    if kind == "sp":
        make_mesh, make_infer = parallel.make_sp_mesh, parallel.make_sp_infer_fn
        grids = (((1, 2), (1, P11["bs"])), ((1, 4), (1, P11["bs"])),
                 ((2, 2), (P11["bs"],)))
    else:
        make_mesh, make_infer = parallel.make_tp_mesh, parallel.make_tp_infer_fn
        grids = (((1, 2), (P11["bs"],)), ((2, 2), (P11["bs"],)))
    f32 = _p11_fused(flagship, torch.float32)
    x32 = normalize_uint8(frames, torch.float32)
    checks, launches = [], 0
    with _no_tf32(), torch.inference_mode():
        one = {bs: fused_detect(f32(x32[:bs]), anchors, **kw)
               for bs in (1, P11["bs"])}
        for (rows, cols), sizes in grids:
            mesh = make_mesh(rows, cols, devices=_cells(rows, cols))
            infer = make_infer(f32, normalized_anchors(), mesh, **kw)
            plain = make_infer(f32, normalized_anchors(), mesh,
                               backend="torch", **kw)
            for bs in sizes:
                checks.append({"grid": f"{rows}x{cols}", **_grid_check(
                    infer, plain, x32[:bs], one[bs])})
                launches += checks[-1]["launches"]
    del f32, x32
    torch.cuda.empty_cache()

    bf16 = _p11_fused(flagship, torch.bfloat16)
    xb = normalize_uint8(frames, torch.bfloat16)
    rates, peaks = {}, {}
    with torch.inference_mode():
        def one_device(bs):
            return lambda: fused_detect(bf16(xb[:bs]), anchors, **kw)

        arms = {"one": one_device}
        for (rows, cols), _ in grids:
            infer = make_infer(bf16, normalized_anchors(), make_mesh(
                rows, cols, devices=_cells(rows, cols)), **kw)
            arms[f"{rows}x{cols}"] = (lambda f: lambda bs: lambda: f(
                xb[:bs]))(infer)
        for name, arm in arms.items():
            s = _timed(arm(P11["bs"]), P11["rounds"])
            _, peaks[name] = _peak(arm(P11["bs"]))
            rates[name] = {"images_per_s_bs16": P11["bs"] / s,
                           "bs16": _device_ms(arm(P11["bs"]))}
            if kind == "sp" and not name.startswith("2x"):
                rates[name]["ms_bs1"] = 1e3 * _timed(arm(1), P11["ms_rounds"])
    del bf16, xb
    torch.cuda.empty_cache()
    res = {"checks": checks, "launches": launches, "rates": rates,
           "peak_gib": peaks}
    log(f"11{'a' if kind == 'sp' else 'c'} {kind.upper()} inference: "
        f"{json.dumps(res)} on {card}")
    bad = _bad_checks(checks)
    if bad:
        raise AssertionError(f"{kind.upper()} inference differs from one "
                             f"device, from the plain NMS, or not one launch "
                             f"a batch: {bad}")
    if min(c["detections"] for c in checks if c["bs"] > 1) < 1:
        raise AssertionError(f"{kind.upper()} inference found no detection "
                             f"in a batch of {P11['bs']}")
    return res


def _p11_trainer(flagship: dict, dtype, kind=None, mesh=None,
                 accumulate: int = 1, mb: int = 0, micro: int = 0):
    """Full-width YOLOv5m from the flagship weights: the plain Trainer, or
    the SP, TP or PP trainer over ``mesh``."""
    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch import parallel
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam

    cfg = Config()
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, compute_dtype=dtype)
    model.load_state_dict(flagship, strict=True)
    model = model.to(device="cuda", memory_format=torch.channels_last)
    loss_fn = YoloLoss(LossConfig.from_config(cfg),
                       np.asarray(ANCHORS, np.float32))
    opt = YoloAdam(model.parameters(), cfg)
    if kind is None:
        return Trainer(model, loss_fn, opt, accumulate)
    data_axis = "data" if "data" in mesh.axis_names else None
    if kind == "sp":
        return parallel.make_sp_train_step(model, loss_fn, opt, mesh,
                                           accumulate, data_axis=data_axis)
    if kind == "tp":
        return parallel.make_tp_train_step(model, loss_fn, opt, mesh,
                                           accumulate, data_axis=data_axis)
    return parallel.make_pp_train_step(model, loss_fn, opt, mesh, mb, micro,
                                       image_hw=(640, 640),
                                       data_axis=data_axis)


def _state_diff(a, b) -> dict:
    """Largest parameter and EMA difference, the share of parameters
    beyond 1e-4, and the largest BN-buffer difference relative above 1."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    params = dict(a.model.named_parameters())
    p_err, buf_err, n, beyond = 0.0, 0.0, 0, 0
    for k, v in sa.items():
        d = (v.float() - sb[k].float()).abs()
        if k in params:
            p_err = max(p_err, float(d.max()))
            beyond += int((d > 1e-4).sum())
            n += d.numel()
        else:
            buf_err = max(buf_err, float(
                (d / sb[k].float().abs().clamp(min=1.0)).max()))
    ema_err = max(float((x - y).abs().max()) for x, y in zip(a.ema, b.ema))
    return {"param_max_abs": p_err, "param_share_beyond_1e-4": beyond / n,
            "ema_max_abs": ema_err, "buffer_max_rel": buf_err}


def grid_train_parity(card: str, kind: str, flagship: dict, batch,
                      grids=((1, 2), (2, 2)), label: str = "") -> dict:
    """11b (SP) and 11c's train step (TP): one bs-4 step on 1x2 and 2x2
    grids of cuda:0 (or ``grids``) against the plain Trainer on the global
    batch, f32 with TF32 off."""
    from yolov5m_tpu_torch import parallel

    make_mesh = (parallel.make_sp_mesh if kind == "sp"
                 else parallel.make_tp_mesh)
    out = {}
    with _no_tf32():
        ref = _p11_trainer(flagship, torch.float32)
        want = ref.train_step(*batch)
        for rows, cols in grids:
            mesh = make_mesh(rows, cols, devices=_cells(rows, cols))
            t = _p11_trainer(flagship, torch.float32, kind, mesh)
            got, peak = _peak(lambda: t.train_step(*batch))
            out[f"{rows}x{cols}"] = {
                "loss": float(got["loss"]), "loss_plain": float(want["loss"]),
                "grad_norm": float(got["grad_norm"]),
                "grad_norm_plain": float(want["grad_norm"]),
                "peak_gib": peak, **_state_diff(t, ref)}
            del t
    del ref
    torch.cuda.empty_cache()
    label = label or f"11{'b' if kind == 'sp' else 'c'}"
    log(f"{label} {kind.upper()} train step at bs {batch[0].shape[0]}, "
        f"{batch[0].shape[1]} px, f32: {json.dumps(out)} on {card}")
    for grid, r in out.items():
        if not (abs(r["loss"] - r["loss_plain"]) <= LOSS_RTOL * abs(
                r["loss_plain"])
                and abs(r["grad_norm"] - r["grad_norm_plain"]) <= GNORM_RTOL
                * r["grad_norm_plain"]
                and r["param_max_abs"] <= PARAM_ATOL
                and r["ema_max_abs"] <= PARAM_ATOL
                and r["buffer_max_rel"] <= BUFFER_TOL):
            raise AssertionError(f"{label}: {kind.upper()} train step on "
                                 f"{grid} differs from the plain Trainer: "
                                 f"{r}")
    return out


def tp_sharding() -> dict:
    """Which leaves of the flagship the 2-way TP splits (variable_pspec)."""
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch.parallel.tp import variable_pspec

    sd = YOLOv5().state_dict()
    whole = sorted(k for k, v in sd.items() if not variable_pspec(v, 2))
    return {"leaves": len(sd), "sharded": len(sd) - len(whole),
            "replicated": whole}


def pp_phase(card: str, flagship: dict, frames) -> dict:
    """11d: make_pp_infer_fn (S 2, M 4, mb 4) against the one-device
    pipeline on each micro-batch (f32, TF32 off), M launches a call, the
    same detections with the plain NMS;
    make_pp_train_step (S 2 and 4) against the Trainer at accumulate 4 on
    the same micro-batches (f32, deterministic); DPxPP 2x2 finite; bf16
    images/s of each against the plain Trainer and one device."""
    from yolov5m_tpu_torch.data.synthetic import synth_batch
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
    from yolov5m_tpu_torch import parallel

    kw = _main_kw()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    micro, mb = P11["micro"], P11["mb"]
    res = {}
    f32 = _p11_fused(flagship, torch.float32)
    x32 = normalize_uint8(frames, torch.float32)
    mesh2 = parallel.make_pp_mesh(2, devices=["cuda:0"] * 2)
    with _no_tf32(), torch.inference_mode():
        infer = parallel.make_pp_infer_fn(f32, normalized_anchors(), mesh2,
                                          mb, micro, image_hw=(640, 640),
                                          **kw)
        plain = parallel.make_pp_infer_fn(f32, normalized_anchors(), mesh2,
                                          mb, micro, image_hw=(640, 640),
                                          backend="torch", **kw)
        nms_kernel.keep_launches = 0
        det, valid = infer(x32)
        torch.cuda.synchronize()
        launches = nms_kernel.keep_launches
        det_p, valid_p = plain(x32)
        plain_same = torch.equal(det, det_p) and torch.equal(valid, valid_p)
        errs = []
        for m in range(micro):
            rows = slice(m * mb, (m + 1) * mb)
            errs.append(_det_error((det[rows], valid[rows]), fused_detect(
                f32(x32[rows]), anchors, **kw), PP_TOL))
    res["infer"] = {"launches": launches, "valid_equal":
                    all(e[0] for e in errs),
                    "max_abs_err": max((e[1] or 0.0) for e in errs),
                    "within_tol": all(e[2] for e in errs),
                    "plain_nms_equal": plain_same,
                    "detections": int(valid.sum())}
    del f32, x32
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = [synth_batch(gen, mb, 640, 80) for _ in range(micro)]
    whole = [torch.cat([b[i] for b in batches]) for i in range(3)]
    train = {}
    with _no_tf32(), _deterministic():
        ref = _p11_trainer(flagship, torch.float32, accumulate=micro)
        want = [ref.train_step(*b) for b in batches]
        for stages in (2, 4):
            mesh = parallel.make_pp_mesh(stages, devices=["cuda:0"] * stages)
            t = _p11_trainer(flagship, torch.float32, "pp", mesh, mb=mb,
                             micro=micro)
            got, peak = _peak(lambda: t.train_step(*whole))
            train[f"S{stages}"] = {
                "loss": float(got["loss"]),
                "loss_plain": statistics.mean(float(w["loss"]) for w in want),
                "grad_norm": float(got["grad_norm"]),
                "grad_norm_plain": float(want[-1]["grad_norm"]),
                "step": t.step, "peak_gib": peak, **_state_diff(t, ref)}
            del t
        del ref
    torch.cuda.empty_cache()
    res["train"] = train

    # bf16 rates, and DPxPP 2x2 (mb 2 a replica): finite losses
    bf16 = _p11_fused(flagship, torch.bfloat16)
    xb = normalize_uint8(frames, torch.bfloat16)
    with torch.inference_mode():
        infer = parallel.make_pp_infer_fn(bf16, normalized_anchors(), mesh2,
                                          mb, micro, image_hw=(640, 640),
                                          **kw)
        arms = {"one_device": lambda: fused_detect(bf16(xb), anchors, **kw),
                "pp_S2": lambda: infer(xb)}
        rates = {}
        for name, arm in arms.items():
            rates[f"infer_{name}"] = P11["bs"] / _timed(arm, P11["rounds"])
            rates[f"infer_{name}_device"] = _device_ms(arm)
    del bf16, xb
    torch.cuda.empty_cache()
    trainers = {"plain": _p11_trainer(flagship, torch.bfloat16,
                                      accumulate=micro)}
    for stages in (2, 4):
        trainers[f"pp_S{stages}"] = _p11_trainer(
            flagship, torch.bfloat16, "pp", parallel.make_pp_mesh(
                stages, devices=["cuda:0"] * stages), mb=mb, micro=micro)
    trainers["dp_pp_2x2"] = _p11_trainer(
        flagship, torch.bfloat16, "pp", parallel.make_dp_pp_mesh(
            2, 2, devices=_cells(2, 2)), mb=mb // 2, micro=micro)
    losses = {}
    for name, t in trainers.items():
        if name == "plain":
            def step(t=t):
                return [t.train_step(*b) for b in batches][-1]
        else:
            def step(t=t):
                return t.train_step(*whole)
        s = _timed(step, P11["train_rounds"], warmup=1)
        m, peak = _peak(step)
        losses[name] = float(m["loss"])
        rates[f"train_{name}"] = P11["bs"] / s
        rates[f"train_{name}_peak_gib"] = peak
    del trainers
    torch.cuda.empty_cache()
    res["rates"] = rates
    res["bf16_losses"] = losses
    log(f"11d PP: {json.dumps(res)} on {card}")
    inf = res["infer"]
    if not (inf["valid_equal"] and inf["within_tol"]
            and inf["plain_nms_equal"]
            and inf["launches"] == micro and inf["detections"] > 0):
        raise AssertionError(f"11d: PP inference {inf}")
    for name, r in train.items():
        if not (r["step"] == micro and r["param_max_abs"] <= PP_TOL
                and r["ema_max_abs"] <= PP_TOL
                and r["buffer_max_rel"] <= PP_TOL
                and abs(r["loss"] - r["loss_plain"]) <= PP_TOL * abs(
                    r["loss_plain"])
                and abs(r["grad_norm"] - r["grad_norm_plain"]) <= PP_TOL
                * r["grad_norm_plain"]):
            raise AssertionError(f"11d: the PP step {name} differs from the "
                                 f"Trainer at accumulate {micro}: {r}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"11d: non-finite bf16 losses {losses}")
    return res


def _reply_diff(a: list, b: list) -> dict:
    """Two servers' replies to the same frames: frames answered alike
    (byte for byte), frames whose detections agree in count and classes,
    and the largest confidence and box differences over those."""
    same, alike, conf, box = 0, 0, 0.0, 0.0
    for x, y in zip(a, b):
        same += x == y
        dx, dy = x.get("detections", []), y.get("detections", [])
        if [d["class_id"] for d in dx] != [d["class_id"] for d in dy]:
            continue
        alike += 1
        for p, q in zip(dx, dy):
            conf = max(conf, abs(p["confidence"] - q["confidence"]))
            box = max(box, max(abs(u - v) for u, v in zip(p["box"],
                                                           q["box"])))
    return {"identical_frames": same, "same_classes_frames": alike,
            "max_conf_diff": conf, "max_box_diff_px": box}


def _phase5_frames() -> list:
    """Phase 5's 16 scenes as PPM frames of 480 to 510 rows."""
    from yolov5m_tpu_torch.data.native import encode_ppm
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8

    gen = torch.Generator(device="cuda").manual_seed(1)    # phase 5's
    scenes = to_uint8(synth_batch(gen, 16, 640, 80)[0]).cpu().numpy()
    return [encode_ppm(scenes[i, :480 + 2 * i]) for i in range(16)]


def _tp_server_pair(model, ppm: list) -> dict:
    """The frames through DetectionServer(tp_devices=[["cuda:0",
    "cuda:0"]]) and the one-device server on ``model``, pipelined by one
    client: the TP server's launches (counted from 0 around its run), each
    of its batches also through make_tp_infer_fn with the plain NMS, and
    the replies compared (``_reply_diff``)."""
    from yolov5m_tpu_torch.config import COCO_LABELS
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.parallel import make_tp_infer_fn, make_tp_mesh
    from yolov5m_tpu_torch.serving.server import (DetectionClient,
                                                  DetectionServer)

    replies, launches, same = {}, 0, []
    for name, extra in (("tp", dict(tp_devices=_cells(1, 2))), ("one", {})):
        server = DetectionServer(model, normalized_anchors(),
                                 labels=COCO_LABELS, conf_threshold=0.25,
                                 batch_size=16, max_wait_ms=1000.0, **extra)
        if name == "tp":
            plain_fn = make_tp_infer_fn(
                model, normalized_anchors(), make_tp_mesh(
                    1, 2, devices=_cells(1, 2)), uint8_ingress=True,
                backend="torch", **server._det_kw)

            def both(x_u8, kernel_fn=server._tp_infer, plain_fn=plain_fn):
                det, valid = kernel_fn(x_u8)
                det_p, valid_p = plain_fn(x_u8)
                same.append(torch.equal(det, det_p)
                            and torch.equal(valid, valid_p))
                return det, valid

            server._tp_infer = both
        with server, DetectionClient(port=server.port) as c:
            nms_kernel.keep_launches = 0
            for f in ppm:             # pipelined: one full batch
                c.send(f)
            replies[name] = [c.recv() for _ in ppm]
            if name == "tp":
                launches = nms_kernel.keep_launches
    return {"frames": len(ppm), "launches": launches,
            "all_ok": all(r.get("ok") for r in replies["tp"]),
            "plain_nms_batches": len(same), "plain_nms_equal": all(same),
            "detections": sum(len(r["detections"]) for r in replies["tp"]),
            "detections_one_device": sum(len(r["detections"])
                                         for r in replies["one"]),
            **_reply_diff(replies["tp"], replies["one"])}


def tp_serving(card: str, flagship: dict) -> dict:
    """11e: DetectionServer(tp_devices=[["cuda:0", "cuda:0"]]) against the
    one-device server on the phase-5 frames, pipelined by one client. In
    f32 (TF32 off) its replies are the one-device server's: the same
    classes on every frame, confidences within SERVE_CONF_TOL and boxes
    within SERVE_BOX_TOL px (the replies round to 1e-5 and 0.01 px). In
    bf16 the split convolutions round otherwise than the whole ones, so
    there the replies are compared and reported, not required equal.
    Both launch the kernel, and each TP batch, warm-up included, also
    runs through make_tp_infer_fn with the plain NMS: its detections must
    be the kernel's."""
    ppm = _phase5_frames()
    res = {}
    for label, dtype, ctx in (("f32", torch.float32, _no_tf32),
                              ("bf16", torch.bfloat16, contextlib.nullcontext)):
        model = _p11_fused(flagship, dtype)
        with ctx():
            res[label] = _tp_server_pair(model, ppm)
        del model
    torch.cuda.empty_cache()
    res["frames"] = len(ppm)
    res["launches"] = res["f32"]["launches"] + res["bf16"]["launches"]
    log(f"11e TP serving over [['cuda:0', 'cuda:0']]: {json.dumps(res)} on "
        f"{card}")
    f = res["f32"]
    if not (f["same_classes_frames"] == len(ppm)
            and f["max_conf_diff"] <= SERVE_CONF_TOL
            and f["max_box_diff_px"] <= SERVE_BOX_TOL and f["detections"]):
        raise AssertionError(f"11e: the f32 TP server's replies differ from "
                             f"the one-device server's: {f}")
    for label in ("f32", "bf16"):
        r = res[label]
        if not (r["launches"] >= 1 and r["all_ok"] and r["plain_nms_equal"]
                and r["plain_nms_batches"] >= 2):
            raise AssertionError(f"11e: the {label} TP server {res[label]}")
    return res


# 11g: SP at heights whose P5 rows split unevenly, ((H, rows, cols), the
# batch sizes): P5's 18 rows 5/5/5/3 over 1x4; 20 rows 3x6, 2, 0 over 1x8
# (an empty shard); 17 rows 5/5/5/2 over 2x4; the train step's grid and
# height. 11h: the int8 grids at bs 16, (kind, rows, cols, H)
P11G = (((576, 1, 4), (1, 16)), ((640, 1, 8), (1, 16)),
        ((544, 2, 4), (16,)))
P11G_TRAIN = (576, (1, 4))
P11H = (("sp", 1, 2, 640), ("sp", 1, 4, 640), ("sp", 1, 4, 576),
        ("tp", 1, 2, 640), ("tp", 2, 2, 640))


def sp_uneven(card: str, flagship: dict, frames) -> dict:
    """11g: make_sp_infer_fn at the heights of P11G (the frames' first H
    rows), f32 with TF32 off, against the one-device pipeline at that
    height: valid equal, within DET_TOL, one launch a batch, the plain NMS
    equal; in bf16 each grid's bs-1 ms and bs-16 images/s against one
    device at its height; make_sp_train_step at P11G_TRAIN with 11b's
    bounds."""
    from yolov5m_tpu_torch.data.synthetic import synth_batch
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
    from yolov5m_tpu_torch import parallel

    kw = _main_kw()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    bs = P11["bs"]

    def mesh_of(rows, cols):
        return parallel.make_sp_mesh(rows, cols, devices=_cells(rows, cols))

    f32 = _p11_fused(flagship, torch.float32)
    checks = []
    with _no_tf32(), torch.inference_mode():
        for (h, rows, cols), sizes in P11G:
            x = normalize_uint8(frames[:, :h].contiguous(), torch.float32)
            mesh = mesh_of(rows, cols)
            infer = parallel.make_sp_infer_fn(f32, normalized_anchors(),
                                              mesh, **kw)
            plain = parallel.make_sp_infer_fn(f32, normalized_anchors(),
                                              mesh, backend="torch", **kw)
            for n in sizes:
                want = fused_detect(f32(x[:n]), anchors, **kw)
                checks.append({"grid": f"{rows}x{cols}", "h": h,
                               **_grid_check(infer, plain, x[:n], want)})
    del f32
    torch.cuda.empty_cache()

    bf16 = _p11_fused(flagship, torch.bfloat16)
    rates = {}
    with torch.inference_mode():
        for (h, rows, cols), sizes in P11G:
            xb = normalize_uint8(frames[:, :h].contiguous(), torch.bfloat16)
            infer = parallel.make_sp_infer_fn(bf16, normalized_anchors(),
                                              mesh_of(rows, cols), **kw)
            arms = {"one": lambda n, xb=xb: lambda: fused_detect(
                        bf16(xb[:n]), anchors, **kw),
                    "grid": lambda n, f=infer, xb=xb: lambda: f(xb[:n])}
            r = {}
            for name, arm in arms.items():
                r[f"{name}_images_per_s_bs16"] = bs / _timed(arm(bs),
                                                             P11["rounds"])
                if 1 in sizes:
                    r[f"{name}_ms_bs1"] = 1e3 * _timed(arm(1),
                                                       P11["ms_rounds"])
            rates[f"{h}@{rows}x{cols}"] = r
    del bf16
    torch.cuda.empty_cache()

    h, grid = P11G_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(13)
    batch = synth_batch(gen, P11["train_bs"], h, 80)
    train = grid_train_parity(card, "sp", flagship, batch, grids=(grid,),
                              label="11g")
    res = {"checks": checks, "launches": sum(c["launches"] for c in checks),
           "rates": rates, "train": train}
    log(f"11g SP at uneven row splits: {json.dumps(res)} on {card}")
    bad = _bad_checks(checks)
    if bad:
        raise AssertionError(f"11g: SP at uneven splits differs from one "
                             f"device, from the plain NMS, or not one launch "
                             f"a batch: {bad}")
    if min(c["detections"] for c in checks if c["bs"] > 1) < 1:
        raise AssertionError(f"11g: no detection in a batch of {bs}")
    return res


def int8_grids(card: str, flagship: dict, frames) -> dict:
    """11h: the flagship quantized in both schemes, calibrated as in 10b
    (on the first P10["calib"] frames, f32), on the grids of P11H at bs
    16: with f32 activations and TF32 off against the one-device int8
    pipeline (valid equal, within DET_TOL, bitwise or not), one launch a
    batch, the plain NMS equal; with bf16 activations (10c's models) each
    grid's images/s against one-device int8 and bf16 in turns; the TP
    server with the bf16 int8 chain model against the one-device int8
    server on phase 5's frames (11e's f32 bounds)."""
    from yolov5m_tpu_torch.models.quantize import model_like, quantize_int8
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
    from yolov5m_tpu_torch import parallel

    kw = _main_kw()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    bs = P11["bs"]
    sd = {k: v.to("cuda") for k, v in flagship.items()}
    template = YOLOv5(fused=True, compute_dtype=torch.bfloat16)
    calib = [normalize_uint8(frames[:P10["calib"]], torch.float32)]
    int8, qsd = {}, {}
    for scheme in ("chain", "block"):
        int8[scheme], qsd[scheme] = quantize_int8(template, sd, calib,
                                                  chain=scheme == "chain")
    del sd

    def grid_infer(model, kind, rows, cols, **extra):
        make_mesh = (parallel.make_sp_mesh if kind == "sp"
                     else parallel.make_tp_mesh)
        make_infer = (parallel.make_sp_infer_fn if kind == "sp"
                      else parallel.make_tp_infer_fn)
        return make_infer(model, normalized_anchors(), make_mesh(
            rows, cols, devices=_cells(rows, cols)), **kw, **extra)

    checks = []
    with _no_tf32(), torch.inference_mode():
        for scheme in int8:
            m32 = model_like(int8[scheme], compute_dtype=None)
            m32.load_state_dict(qsd[scheme], strict=True)
            m32 = m32.to(device="cuda", memory_format=torch.channels_last)
            m32.eval()
            wants = {}
            for kind, rows, cols, h in P11H:
                x = normalize_uint8(frames[:, :h].contiguous(), torch.float32)
                if h not in wants:
                    wants[h] = fused_detect(m32(x), anchors, **kw)
                checks.append({
                    "scheme": scheme, "grid": f"{kind.upper()} {rows}x{cols}",
                    "h": h, **_grid_check(
                        grid_infer(m32, kind, rows, cols),
                        grid_infer(m32, kind, rows, cols, backend="torch"),
                        x, wants[h])})
            del m32
    torch.cuda.empty_cache()

    bf16 = _p11_fused(flagship, torch.bfloat16)
    rates = {}
    with torch.inference_mode():
        for h in sorted({h for *_, h in P11H}, reverse=True):
            xb = normalize_uint8(frames[:, :h].contiguous(), torch.bfloat16)
            arms = {"bf16": bf16, "int8_chain": int8["chain"],
                    "int8_block": int8["block"]}
            arms = {name: (lambda m: lambda: fused_detect(m(xb), anchors,
                                                          **kw))(m)
                    for name, m in arms.items()}
            for kind, rows, cols, gh in P11H:
                if gh != h:
                    continue
                for scheme, m in int8.items():
                    arms[f"{kind}_{rows}x{cols}_{scheme}"] = (
                        lambda f: lambda: f(xb))(grid_infer(m, kind, rows,
                                                             cols))
            rates[str(h)] = {name: bs / _timed(arm, P11["rounds"])
                             for name, arm in arms.items()}
    del bf16
    torch.cuda.empty_cache()
    serve = _tp_server_pair(int8["chain"], _phase5_frames())
    del int8
    torch.cuda.empty_cache()
    res = {"checks": checks, "launches": sum(c["launches"] for c in checks),
           "images_per_s": rates, "tp_serving": serve,
           "max_abs_err": max(c["max_abs_err"] or 0.0 for c in checks)}
    log(f"11h int8 on the grids: {json.dumps(res)} on {card}")
    bad = _bad_checks(checks)
    if bad:
        raise AssertionError(f"11h: int8 on a grid differs from one device, "
                             f"from the plain NMS, or not one launch a "
                             f"batch: {bad}")
    if min(c["detections"] for c in checks) < 1:
        raise AssertionError(f"11h: no detection in a batch of {bs}")
    if not (serve["same_classes_frames"] == serve["frames"]
            and serve["max_conf_diff"] <= SERVE_CONF_TOL
            and serve["max_box_diff_px"] <= SERVE_BOX_TOL
            and serve["detections"] and serve["launches"] >= 1
            and serve["all_ok"] and serve["plain_nms_equal"]
            and serve["plain_nms_batches"] >= 2):
        raise AssertionError(f"11h: the int8 TP server's replies differ from "
                             f"the one-device int8 server's: {serve}")
    return res


def grid_refusal() -> str:
    """11f: the train CLI with --sp 2 on one card exits before any work,
    naming the device count."""
    from yolov5m_tpu_torch.cli import train as train_cli

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            try:
                train_cli.main(train_cli.arg_parser(
                    ["--data", "synth", "--sp", "2", "--nosaveimgs"]))
                msg = None
            except SystemExit as e:
                msg = str(e)
            left = os.listdir(tmp)
        finally:
            os.chdir(cwd)
    log(f"11f train CLI --sp 2 on {torch.cuda.device_count()} card(s): "
        f"SystemExit {msg!r}, files left {left}")
    want = f"have {torch.cuda.device_count()} cuda devices"
    if msg is None or want not in msg or left:
        raise AssertionError(f"11f: --sp 2 on one card was not refused before "
                             f"any work: {msg!r}, {left}")
    return msg


def grid_phase(card: str, flagship: dict) -> dict:
    """Phase 11: SP (11a, 11b), TP (11c), PP (11d), TP serving (11e), the
    refusal (11f), SP at uneven row splits (11g) and the int8 models on
    the grids (11h), on grids that repeat cuda:0."""
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(12)
    frames = to_uint8(synth_batch(gen, P11["bs"], 640, 80)[0])
    batch = synth_batch(gen, P11["train_bs"], 640, 80)
    res = {"sp_infer": grid_inference(card, "sp", flagship, frames),
           "sp_train": grid_train_parity(card, "sp", flagship, batch),
           "tp_infer": grid_inference(card, "tp", flagship, frames),
           "tp_train": grid_train_parity(card, "tp", flagship, batch),
           "tp_sharding": tp_sharding(),
           "pp": pp_phase(card, flagship, frames),
           "tp_serving": tp_serving(card, flagship),
           "refusal": grid_refusal(),
           "sp_uneven": sp_uneven(card, flagship, frames),
           "int8_grids": int8_grids(card, flagship, frames)}
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 11 (SP, TP and PP on one card): {res['seconds']:.1f} s")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO_ROOT)
    from yolov5m_tpu_torch.data import native
    from yolov5m_tpu_torch.ops import nms
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    nms_kernel.build()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{nms_kernel.build_seconds})")
    log(nms_kernel.build_log.strip() or "build: the library was already "
        "built; nvcc's -Xptxas -v report comes from the process that builds")
    native.build()         # the host library: phase 7 resizes with it
    log(f"build: {native.build_command} ({native.build_seconds} s)")

    timings = kernel_vs_plain(nms, nms_kernel)
    main = main_path(card)
    p4 = {k: main.pop(k) for k in ("model", "frames", "valid_counts")}
    serve_launches = serve_frames(p4["model"])
    # phase 9 reads them again; on the host meanwhile, so that the peak
    # memory of phases 6-8 holds only their own tensors
    p4["model"], p4["frames"] = (p4["model"].cpu(),
                                 [f.cpu() for f in p4["frames"]])
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    trained = train_steps(card)
    train_ips, train_peak = trained["images_per_s"], trained["peak_gib"]
    ev = evaluate(card, trained)
    cli_launches, cli_image_launches, stripped = train_cli_cycle(trained)
    log(f"phase 6 (train, evaluate, CLI): {time.perf_counter() - t6:.1f} s")
    flagship = trained["flagship"]
    del trained
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        disk = disk_phase(card, flagship, tmp)
        torch.cuda.empty_cache()
        dp = dp_phase(card, flagship)
        torch.cuda.empty_cache()
        p4 = dict(p4, model=p4["model"].cuda(),
                  frames=[f.cuda() for f in p4["frames"]])
        host = host_export_phase(card, os.path.join(tmp, "disk"),
                                 os.path.join(tmp, "flagship.npz"), p4,
                                 flagship, stripped,
                                 disk["detect"]["images_per_s"])
        torch.cuda.empty_cache()
        int8 = int8_phase(card, p4, os.path.join(tmp, "disk"),
                          os.path.join(tmp, "flagship.npz"),
                          disk["detect"].pop("results"))
    del p4
    torch.cuda.empty_cache()
    grids = grid_phase(card, flagship)

    k = main["kernel"]
    kernels = [{
        "name": "nms_greedy_keep", "route": "cuda",
        "source": "yolov5m_tpu_torch/csrc/nms.cu", "replaces": REPLACES,
        "launches": k["launches"], "serve_launches": serve_launches,
        "mismatches": k["mismatches"] + main["evaluator"]["mismatches"],
        "max_abs_err": max(k["max_abs_err"],
                           main["evaluator"]["max_abs_err"]),
        "ms": k["ms"], "call_ms": k["call_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None, "evaluator": main["evaluator"],
        "eval_launches": ev["launches"], "eval_loop": ev["kernel"],
        "train_cli_launches": cli_launches,
        "train_cli_image_launches": cli_image_launches,
        "disk_eval_launches": disk["eval"]["launches"],
        "detect_launches": disk["detect"]["launches"],
        "save_pred_launches": disk["save_pred"]["launches"],
        "disk_train_cli_launches": disk["cli"]["launches"],
        "png_eval_launches": disk["png"]["eval_launches"],
        "png_detect_launches": disk["png"]["detect_launches"],
        "dp_serve_launches": dp["serving"]["launches"],
        "dp_eval_launches": dp["eval_launches"],
        "compact_gate_launches": host["gate"]["compact_gate_launches"],
        "gate_density_launches":
            host["gate"]["density"]["gate_density_launches"],
        "jpeg_detect_launches": host["jpeg"]["detect_launches"],
        "jpeg_serve_launches": host["jpeg"]["serve_launches"],
        "jpeg_arith_detect_launches":
            host["jpeg"]["arith_detect"]["launches"],
        "pillow_detect_launches": host["pillow"]["detect_launches"],
        "pillow_detect_img_launches": host["pillow"]["img_launches"],
        "pillow_serve_launches": host["pillow"]["serve_launches"],
        "webp_detect_launches": host["webp"]["detect_launches"],
        "webp_detect_img_launches": host["webp"]["img_launches"],
        "webp_serve_launches": host["webp"]["serve_launches"],
        "pnm_detect_launches": host["pnm"]["detect_launches"],
        "pnm_detect_img_launches": host["pnm"]["img_launches"],
        "pnm_serve_launches": host["pnm"]["serve_launches"],
        "tiff_detect_launches": host["tiff"]["detect_launches"],
        "tiff_detect_img_launches": host["tiff"]["img_launches"],
        "tiff_serve_launches": host["tiff"]["serve_launches"],
        "tiff_jpeg_detect_launches": host["tiff_jpeg"]["detect_launches"],
        "tiff_jpeg_detect_img_launches": host["tiff_jpeg"]["img_launches"],
        "tiff_jpeg_serve_launches": host["tiff_jpeg"]["serve_launches"],
        "tiff_zstd_lzma_detect_launches":
            host["tiff_zstd_lzma"]["detect_launches"],
        "tiff_zstd_lzma_detect_img_launches":
            host["tiff_zstd_lzma"]["img_launches"],
        "tiff_zstd_lzma_serve_launches":
            host["tiff_zstd_lzma"]["serve_launches"],
        "tiff_ojpeg_detect_launches": host["tiff_ojpeg"]["detect_launches"],
        "tiff_ojpeg_detect_img_launches":
            host["tiff_ojpeg"]["img_launches"],
        "tiff_ojpeg_serve_launches": host["tiff_ojpeg"]["serve_launches"],
        "tiff_legacy_zstd_detect_launches":
            host["tiff_legacy_lab"]["zstd"]["detect_launches"],
        "tiff_legacy_zstd_detect_img_launches":
            host["tiff_legacy_lab"]["zstd"]["img_launches"],
        "tiff_legacy_zstd_serve_launches":
            host["tiff_legacy_lab"]["zstd"]["serve_launches"],
        "tiff_lab_detect_launches":
            host["tiff_legacy_lab"]["lab"]["detect_launches"],
        "tiff_lab_detect_img_launches":
            host["tiff_legacy_lab"]["lab"]["img_launches"],
        "tiff_lab_serve_launches":
            host["tiff_legacy_lab"]["lab"]["serve_launches"],
        "tiff_fax_detect_launches":
            host["tiff_fax"]["fax"]["detect_launches"],
        "tiff_fax_detect_img_launches":
            host["tiff_fax"]["fax"]["img_launches"],
        "tiff_fax_serve_launches": host["tiff_fax"]["fax"]["serve_launches"],
        "tiff_thunder_detect_launches":
            host["tiff_fax"]["thunder"]["detect_launches"],
        "tiff_thunder_detect_img_launches":
            host["tiff_fax"]["thunder"]["img_launches"],
        "tiff_thunder_serve_launches":
            host["tiff_fax"]["thunder"]["serve_launches"],
        "jpeg2k_detect_launches": host["jpeg2k"]["detect_launches"],
        "jpeg2k_detect_img_launches": host["jpeg2k"]["img_launches"],
        "jpeg2k_serve_launches": host["jpeg2k"]["serve_launches"],
        "raster_detect_launches": host["raster"]["detect_launches"],
        "raster_detect_img_launches": host["raster"]["img_launches"],
        "raster_serve_launches": host["raster"]["serve_launches"],
        "bcn_detect_launches": host["bcn"]["detect_launches"],
        "bcn_detect_img_launches": host["bcn"]["img_launches"],
        "bcn_serve_launches": host["bcn"]["serve_launches"],
        "s2d_launches": int8["s2d"]["s2d_launches"],
        "int8_launches": int8["int8"]["int8_launches"],
        "int8_detect_launches": int8["detect"]["launches"],
        "sp_launches": grids["sp_infer"]["launches"],
        "tp_launches": grids["tp_infer"]["launches"],
        "pp_launches": grids["pp"]["infer"]["launches"],
        "tp_serve_launches": grids["tp_serving"]["launches"],
        "sp_uneven_launches": grids["sp_uneven"]["launches"],
        "int8_grid_launches": grids["int8_grids"]["launches"],
        "int8_tp_serve_launches":
            grids["int8_grids"]["tp_serving"]["launches"],
        "per_k": timings}]
    log(f"{card}: main path {main['images_per_s']:.2f} images/s, "
        f"{main['detections_per_image']:.3f} detections/image; training "
        f"{train_ips:.2f} images/s, peak {train_peak:.3f} GiB; evaluator "
        f"{ev['images_per_s']:.2f} images/s, flagship map50 "
        f"{ev['flagship']['map50']:.4f}; disk training "
        f"{disk['train']['images_per_s']:.2f} images/s, disk eval "
        f"{disk['eval']['images_per_s']:.2f} images/s, map50 "
        f"{disk['eval']['metrics']['map50']:.4f}; detect "
        f"{disk['detect']['images_per_s']:.2f} images/s (with --save_pred "
        f"{disk['save_pred']['images_per_s']['save_pred']:.2f}, without "
        f"{disk['save_pred']['images_per_s']['plain']:.2f} in 7h); "
        f"prediction images at 640x480 "
        f"{host['plots']['ms']['plot_image_640x480']:.1f} ms (plot_image), "
        f"{host['plots']['ms']['save_prediction_images_640x480']:.1f} ms "
        f"(save_prediction_images); PNG disk training "
        f"with the host augmentation "
        f"{disk['png']['train']['images_per_s']:.2f} images/s, PNG detect "
        f"{disk['png']['detect']['images_per_s']:.2f} images/s")
    log("phase 7: " + json.dumps(disk))
    log(f"{card}: DP trainer at world size 1 "
        f"{dp['world1']['images_per_s_dp']:.2f} images/s against the plain "
        f"Trainer's {dp['world1']['images_per_s_plain']:.2f}; DP serving "
        f"over two replicas on one card {dp['serving']['images_per_s']:.2f} "
        f"images/s")
    log("phase 8: " + json.dumps(dp))
    n = host["native"]["batch_build"]
    g = host["gate"]["images_per_s"]
    log(f"{card}: loader batch build on one thread {n['c']['one_thread_ms']:.2f}"
        f" ms with the C resize, {n['numpy']['one_thread_ms']:.2f} ms with "
        f"numpy; main path {g['sort']:.2f} images/s with the sort gate, "
        f"{g['compact']:.2f} with the compact gate; idle share of a traced "
        f"batch {host['trace']['idle_share']}")
    log("phase 9: " + json.dumps(host))
    ips = int8["int8"]["images_per_s"]
    peak = int8["int8"]["peak_gib"]
    stem = int8["s2d"]["stem_ms"]
    log(f"{card}: main path bf16 {ips['bf16']:.2f}, int8 chain "
        f"{ips['chain']:.2f}, int8 per block {ips['block']:.2f} images/s "
        f"(peak {peak['bf16']:.3f} / {peak['chain']:.3f} / "
        f"{peak['block']:.3f} GiB); s2d {int8['s2d']['images_per_s']['s2d']:.2f}"
        f" against 6x6 {int8['s2d']['images_per_s']['6x6']:.2f} images/s; "
        f"stem {stem['s2d']:.3f} ms s2d (+{stem['space_to_depth']:.3f} ms "
        f"space-to-depth) against {stem['6x6']:.3f} ms 6x6")
    log("phase 10: " + json.dumps(int8))
    sp, tp = grids["sp_infer"]["rates"], grids["tp_infer"]["rates"]
    pp = grids["pp"]["rates"]
    log(f"{card}: SP bs 1 {sp['one']['ms_bs1']:.3f} ms on one device, "
        f"{sp['1x2']['ms_bs1']:.3f} over 1x2, {sp['1x4']['ms_bs1']:.3f} over "
        f"1x4; bs 16 images/s one device {sp['one']['images_per_s_bs16']:.2f}"
        f", SP 1x2 {sp['1x2']['images_per_s_bs16']:.2f}, 2x2 "
        f"{sp['2x2']['images_per_s_bs16']:.2f}, TP 1x2 "
        f"{tp['1x2']['images_per_s_bs16']:.2f}, 2x2 "
        f"{tp['2x2']['images_per_s_bs16']:.2f}; training images/s plain "
        f"{pp['train_plain']:.2f}, PP S2 {pp['train_pp_S2']:.2f}, S4 "
        f"{pp['train_pp_S4']:.2f}, DPxPP 2x2 {pp['train_dp_pp_2x2']:.2f} "
        "(grids of one card: the port's overhead, not scaling)")
    ug, ig = grids["sp_uneven"]["rates"], grids["int8_grids"]["images_per_s"]
    log(f"{card}: SP at uneven splits, bs 16 images/s grid / one device: "
        + ", ".join(f"{k} {v['grid_images_per_s_bs16']:.2f} / "
                    f"{v['one_images_per_s_bs16']:.2f}" for k, v in ug.items())
        + "; int8 at 640 bs 16 images/s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ig["640"].items()))
    log("phase 11: " + json.dumps(grids))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
