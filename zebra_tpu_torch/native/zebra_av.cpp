// The torch port's own copy of zebra_tpu/native/zebra_av.cpp (the code below
// is unchanged).
//
// Generic audio decode via the system ffmpeg libraries (libavformat /
// libavcodec / libswresample) — the catch-all native decoder behind the
// format-specific paths (stdlib containers, in-tree FLAC, libmpg123,
// libvorbisfile). Covers aac/m4a, opus, wma, alac, ... — the remainder of
// the codec surface the reference gets from symphonia
// (the reference's src/model/audio.rs:35-75).
//
// API: za_decode(path) -> mono float32 PCM at the stream's native sample
// rate (channels averaged by swresample's mono downmix). Built lazily with
// g++ against the distro's ffmpeg 5.x dev headers; av.py falls back to
// soundfile/SDL_mixer when the toolchain or the libraries are absent.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Decoded {
    std::vector<float> pcm;
    int rate = 0;
};

// Convert one frame (or flush when frame == nullptr) into out.
int convert_into(SwrContext* swr, const AVFrame* frame, std::vector<float>& out) {
    const int in_n = frame ? frame->nb_samples : 0;
    // worst-case output count: queued + incoming samples (no resampling, but
    // swr may hold a few samples of delay for fmt conversion)
    const int max_out = in_n + 256;
    size_t base = out.size();
    out.resize(base + (size_t)max_out);
    uint8_t* dst[1] = {reinterpret_cast<uint8_t*>(out.data() + base)};
    int got = swr_convert(swr, dst, max_out,
                          frame ? const_cast<const uint8_t**>(frame->extended_data)
                                : nullptr,
                          in_n);
    if (got < 0) {
        out.resize(base);
        return got;
    }
    out.resize(base + (size_t)got);
    return 0;
}

int decode_file(const char* path, Decoded& result) {
    av_log_set_level(AV_LOG_ERROR);  // demuxer chatter would hit the CLI
    AVFormatContext* fmt = nullptr;
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return 1;

    AVCodecContext* ctx = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int rc = 0;

    do {
        if (avformat_find_stream_info(fmt, nullptr) < 0) { rc = 2; break; }
        const AVCodec* dec = nullptr;
        int stream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
        if (stream < 0 || !dec) { rc = 3; break; }

        ctx = avcodec_alloc_context3(dec);
        if (!ctx) { rc = 4; break; }
        if (avcodec_parameters_to_context(ctx, fmt->streams[stream]->codecpar) < 0) {
            rc = 5; break;
        }
        if (avcodec_open2(ctx, dec, nullptr) < 0) { rc = 6; break; }

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        if (!pkt || !frame) { rc = 7; break; }

        bool drained = false;
        while (!drained && rc == 0) {
            int r = av_read_frame(fmt, pkt);
            if (r < 0) {
                avcodec_send_packet(ctx, nullptr);  // enter drain mode
                drained = true;
            } else if (pkt->stream_index != stream) {
                av_packet_unref(pkt);
                continue;
            } else {
                r = avcodec_send_packet(ctx, pkt);
                av_packet_unref(pkt);
                if (r < 0 && r != AVERROR(EAGAIN)) { rc = 8; break; }
            }
            while (true) {
                r = avcodec_receive_frame(ctx, frame);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
                if (r < 0) { rc = 9; break; }
                if (!swr) {
                    // init from the FIRST real frame: some demuxers leave
                    // the codec context's layout/rate unset until decode
                    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
                    if (frame->ch_layout.nb_channels <= 0 ||
                        frame->sample_rate <= 0) { rc = 10; break; }
                    if (swr_alloc_set_opts2(
                            &swr, &mono, AV_SAMPLE_FMT_FLT, frame->sample_rate,
                            &frame->ch_layout, (AVSampleFormat)frame->format,
                            frame->sample_rate, 0, nullptr) < 0 ||
                        swr_init(swr) < 0) { rc = 11; break; }
                    result.rate = frame->sample_rate;
                }
                if (convert_into(swr, frame, result.pcm) < 0) { rc = 12; break; }
                av_frame_unref(frame);
            }
        }
        if (rc == 0 && swr) convert_into(swr, nullptr, result.pcm);  // flush
        if (result.pcm.empty()) rc = rc ? rc : 13;
    } while (false);

    if (swr) swr_free(&swr);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return rc;
}

}  // namespace

extern "C" {

// Decode the audio file at `path` to mono float32 at native rate.
// Returns 0 on success; *out is malloc'd (free with za_free).
int za_decode(const char* path, float** out, long long* n_samples, int* rate) {
    *out = nullptr;
    *n_samples = 0;
    *rate = 0;
    Decoded d;
    int rc = decode_file(path, d);
    if (rc != 0) return rc;
    float* buf = static_cast<float*>(malloc(d.pcm.size() * sizeof(float)));
    if (!buf) return 14;
    std::memcpy(buf, d.pcm.data(), d.pcm.size() * sizeof(float));
    *out = buf;
    *n_samples = (long long)d.pcm.size();
    *rate = d.rate;
    return 0;
}

void za_free(float* p) { free(p); }

// TEST-ONLY helper: synthesize a mono sine of `freq` Hz, `n` samples at
// `rate`, encode it with the named codec into the named container at
// `path` (e.g. codec "aac" + format "adts", codec "libopus"/"opus" +
// format "ogg"). Exists so the test suite can exercise decode paths for
// codecs with no sample files on disk; never called by library code.
int za_encode_test(const char* path, const char* codec_name,
                   const char* format_name, int rate, int n, double freq) {
    av_log_set_level(AV_LOG_ERROR);
    const AVCodec* enc = avcodec_find_encoder_by_name(codec_name);
    if (!enc) return 1;
    AVFormatContext* fmt = nullptr;
    if (avformat_alloc_output_context2(&fmt, nullptr, format_name, path) < 0 ||
        !fmt)
        return 2;
    AVCodecContext* ctx = avcodec_alloc_context3(enc);
    SwrContext* swr = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    int rc = 0;
    do {
        ctx->sample_rate = rate;
        AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
        av_channel_layout_copy(&ctx->ch_layout, &mono);
        ctx->sample_fmt = enc->sample_fmts ? enc->sample_fmts[0]
                                           : AV_SAMPLE_FMT_FLTP;
        ctx->bit_rate = 96000;
        ctx->time_base = AVRational{1, rate};
        if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
            ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        if (avcodec_open2(ctx, enc, nullptr) < 0) { rc = 3; break; }
        AVStream* st = avformat_new_stream(fmt, nullptr);
        if (!st) { rc = 4; break; }
        st->time_base = ctx->time_base;
        if (avcodec_parameters_from_context(st->codecpar, ctx) < 0) {
            rc = 5; break;
        }
        if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
            avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) { rc = 6; break; }
        if (avformat_write_header(fmt, nullptr) < 0) { rc = 7; break; }

        // f32 sine -> encoder's sample format via swr
        AVChannelLayout mono2 = AV_CHANNEL_LAYOUT_MONO;
        if (swr_alloc_set_opts2(&swr, &mono2, ctx->sample_fmt, rate, &mono2,
                                AV_SAMPLE_FMT_FLT, rate, 0, nullptr) < 0 ||
            swr_init(swr) < 0) { rc = 8; break; }

        frame = av_frame_alloc();
        pkt = av_packet_alloc();
        if (!frame || !pkt) { rc = 9; break; }
        const int chunk = ctx->frame_size > 0 ? ctx->frame_size : 1024;
        std::vector<float> sine((size_t)chunk);
        long long pts = 0;
        int produced = 0;
        bool flushed = false;
        while (rc == 0 && !flushed) {
            int send_rc;
            if (produced < n) {
                int m = n - produced < chunk ? n - produced : chunk;
                for (int i = 0; i < m; ++i)
                    sine[(size_t)i] = 0.5f * (float)std::sin(
                        2.0 * 3.14159265358979323846 * freq *
                        (double)(produced + i) / (double)rate);
                for (int i = m; i < chunk; ++i) sine[(size_t)i] = 0.0f;
                frame->nb_samples = chunk;
                av_channel_layout_copy(&frame->ch_layout, &mono2);
                frame->format = ctx->sample_fmt;
                frame->sample_rate = rate;
                if (av_frame_get_buffer(frame, 0) < 0) { rc = 10; break; }
                const uint8_t* src[1] = {
                    reinterpret_cast<const uint8_t*>(sine.data())};
                if (swr_convert(swr, frame->extended_data, chunk, src, chunk) <
                    0) { rc = 11; break; }
                frame->pts = pts;
                pts += chunk;
                produced += m;
                send_rc = avcodec_send_frame(ctx, frame);
                av_frame_unref(frame);
            } else {
                send_rc = avcodec_send_frame(ctx, nullptr);
                flushed = true;
            }
            if (send_rc < 0 && send_rc != AVERROR(EAGAIN)) { rc = 12; break; }
            while (true) {
                int r = avcodec_receive_packet(ctx, pkt);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
                if (r < 0) { rc = 13; break; }
                av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
                pkt->stream_index = st->index;
                if (av_interleaved_write_frame(fmt, pkt) < 0) { rc = 14; break; }
            }
        }
        if (rc == 0) av_write_trailer(fmt);
    } while (false);
    if (swr) swr_free(&swr);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) {
        if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
            avio_closep(&fmt->pb);
        avformat_free_context(fmt);
    }
    return rc;
}

}  // extern "C"
